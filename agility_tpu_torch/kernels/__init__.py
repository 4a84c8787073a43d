"""The hand-written kernels' wrappers; each counts its launches (CUDA
tensors only) in `<wrapper>.launches`."""


def _wrappers() -> dict:
    from agility_tpu_torch.kernels import contact_lcp, scandots, terrain_window, window_dma

    return dict(contact_lcp=contact_lcp.contact_lcp,
                terrain_window=terrain_window.terrain_window,
                scandots=scandots.scandots,
                per_env_windows=window_dma.per_env_windows,
                band_windows=window_dma.band_windows)


def launch_counts() -> dict:
    """{wrapper: launches so far} of K1, K2, K3, D and E."""
    return {name: w.launches for name, w in _wrappers().items()}


def zero_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for w in _wrappers().values():
        w.launches = 0
