"""The hand-written kernels' wrappers; each counts its launches (CUDA
tensors only) in `<wrapper>.launches`."""


def launch_counts() -> dict:
    """{wrapper: launches so far} of K1, K2 and K3."""
    from agility_tpu_torch.kernels import contact_lcp, scandots, terrain_window

    return dict(contact_lcp=contact_lcp.contact_lcp.launches,
                terrain_window=terrain_window.terrain_window.launches,
                scandots=scandots.scandots.launches)
