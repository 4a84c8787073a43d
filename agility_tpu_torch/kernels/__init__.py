"""The hand-written kernels' wrappers; each counts its launches (CUDA
tensors only) in `<wrapper>.launches`.  The free-dynamics kernel launches
inside stage A's CUDA graph (physics/soa.py:FREE_DYNAMICS), so its wrapper
counts its calls, and its launches on the device are its eager calls and
the graph's replays."""


def _wrappers() -> dict:
    from agility_tpu_torch.kernels import contact_lcp, scandots, terrain_window, window_dma

    return dict(contact_lcp=contact_lcp.contact_lcp,
                terrain_window=terrain_window.terrain_window,
                scandots=scandots.scandots,
                per_env_windows=window_dma.per_env_windows,
                band_windows=window_dma.band_windows)


def _free_dynamics():
    from agility_tpu_torch.kernels.free_dynamics import free_dynamics
    from agility_tpu_torch.physics.soa import FREE_DYNAMICS

    return free_dynamics, FREE_DYNAMICS


def launch_counts() -> dict:
    """{kernel: launches on the device so far} of K1, K2, K3, D, E and the
    free-dynamics kernel (its eager calls, GraphCache's warm-ups among
    them, and the replays of stage A's graph, which launches it once)."""
    fd, graph = _free_dynamics()
    return dict({name: w.launches for name, w in _wrappers().items()},
                free_dynamics=fd.eager + graph.replays)


def zero_launch_counts() -> None:
    """Set every count of launch_counts to 0 (the free-dynamics wrapper's
    calls and stage A's graph replays with it)."""
    for w in _wrappers().values():
        w.launches = 0
    fd, graph = _free_dynamics()
    fd.launches = fd.eager = graph.replays = 0
