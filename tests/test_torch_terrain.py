"""The port's terrain layer vs agility_tpu: the layered heightfield, the
seesaw lever arm, and the plain versions of kernels K2 (terrain window) and
K3 (scandots), on the same inputs made with numpy from a seed.

K2's and K3's plain versions are held to exact equality with the gather
path of agility_tpu/physics/patch.py, which JAX runs op by op here, so it
rounds after every multiply and add as the port does (K3 folds in
bfloat16).  They are also held against the Pallas kernels themselves
(physics/windows.py) run in interpret mode, as tests/test_windows.py runs
them on the CPU: interpret mode traces the kernel body under jit, where
XLA-CPU contracts the floor fold h + lever * w into one fused multiply-add,
so K2's floor may differ there by a rounding of the product (< 1e-7 m).  The bilinear samplers
agree to 1e-6 (float32 sums of four weighted nodes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agility_tpu.envs.tsc_config import tsc_smoke_cfg
from agility_tpu.physics import heightfield as jhf
from agility_tpu.physics import patch as jpt
from agility_tpu.physics import windows as jwin
from agility_tpu.terrain import obstacle as jobst
from agility_tpu_torch.kernels import scandots as k3
from agility_tpu_torch.kernels import terrain_window as k2
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics import patch as tpt
from agility_tpu_torch.terrain import obstacle as tobst

N, H, W = 8, 96, 128


def _surfaces(rng, ceiling=True):
    """Rough floor, two movable layers, a lever field and a ceiling with its
    own layer tags."""
    s = dict(height_m=(0.2 * rng.normal(size=(H, W))).astype(np.float32))
    s["layer_id"] = np.zeros((H, W), np.int8)
    s["layer_id"][20:30, 40:60] = 1
    s["layer_id"][50:60, 70:90] = 2
    s["lever"] = np.zeros((H, W), np.float32)
    s["lever"][70:80, 30:50] = np.linspace(-0.5, 0.5, 20)[None, :]
    if ceiling:
        s["ceiling"] = np.full((H, W), jhf.NO_CEILING, np.float32)
        s["ceiling"][30:40, 20:40] = 0.45
        s["ceiling_layer"] = np.zeros((H, W), np.int8)
        s["ceiling_layer"][30:40, 30:40] = 1
    return s


def _grids(rng, ceiling=True):
    s = _surfaces(rng, ceiling)
    return (jhf.from_numpy(hscale=0.05, origin_xy=(-1.0, -1.0), **s),
            thf.from_numpy(hscale=0.05, origin_xy=(-1.0, -1.0), device="cpu", **s))


def _centers(rng, n=N):
    # inside the world, plus one centre off each edge (clamped origins)
    c = np.stack([rng.uniform(-0.4, 2.9, n), rng.uniform(-0.4, 4.5, n)], -1)
    c[0], c[1] = (-2.0, 9.0), (6.0, -3.0)
    return c.astype(np.float32)


def _weights(rng, n=N):
    return rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)   # 2 layers + lever tilt


@pytest.fixture(scope="module")
def world():
    return jobst.generate(tsc_smoke_cfg(num_envs=4, courses=2).obstacle, seed=0)


@pytest.mark.parametrize("fn", ["sample_height", "sample_height_min3", "sample_ceiling"])
def test_heightfield_with_weights_matches(rng, fn):
    jg, tg = _grids(rng)
    x = rng.uniform(-1.3, 4.0, (N, 6)).astype(np.float32)
    y = rng.uniform(-1.3, 5.5, (N, 6)).astype(np.float32)
    w = _weights(rng)
    ref = jax.vmap(lambda a, b, c: getattr(jhf, fn)(jg, a, b, c))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    got = getattr(thf, fn)(tg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # and without weights: the plain surface
    ref0 = getattr(jhf, fn)(jg, jnp.asarray(x), jnp.asarray(y))
    got0 = getattr(thf, fn)(tg, torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-6)


def test_lever_arm_matches(world, rng):
    pose = world.seesaw_pose.astype(np.float32)                     # (2, 5)
    # points over and around each plank
    t = rng.uniform(-2.0, 2.0, (2, 64))
    p = rng.uniform(-0.5, 0.5, (2, 64))
    c, s = np.cos(pose[:, 2:3]), np.sin(pose[:, 2:3])
    x = (pose[:, 0:1] + c * t - s * p).astype(np.float32)
    y = (pose[:, 1:2] + s * t + c * p).astype(np.float32)
    ref = np.asarray(jobst.lever_arm(jnp.asarray(pose)[:, None, :], jnp.asarray(x),
                                     jnp.asarray(y)))
    got = tobst.lever_arm(torch.as_tensor(pose)[:, None, :], torch.as_tensor(x),
                          torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref != 0).sum() > 20 and (ref == 0).sum() > 20


@pytest.mark.parametrize("ceiling,weighted", [(True, True), (True, False), (False, True)])
def test_extract_batch_matches(rng, ceiling, weighted):
    jg, tg = _grids(rng, ceiling)
    c = _centers(rng)
    w = _weights(rng) if weighted else None
    ref = jpt.extract_batch(jg, jnp.asarray(c), 32, None if w is None else jnp.asarray(w))
    got = tpt.extract_batch(tg, torch.as_tensor(c), 32,
                            None if w is None else torch.as_tensor(w))
    for f in ("values", "x0", "y0") + (("ceil",) if ceiling else ()):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert (got.ceil is None) == (not ceiling)
    assert int(got.x0.min()) == 0 and int(got.y0.min()) == 0          # clamped at the edges
    assert int(got.x0.max()) == H - 32 and int(got.y0.max()) == W - 32


def test_extract_batch_matches_pallas_kernel(rng, monkeypatch):
    """Against the TPU kernel K2 replaces (extract_band_batch, interpret
    mode): the band's window cells at its (roff, coff) offsets."""
    monkeypatch.setenv("AGILITY_WINDOWS", "interpret")
    jg, tg = _grids(rng)
    jg = jwin.attach_bands(jg, contact_size=32)
    c, w = _centers(rng), _weights(rng)
    bp = jwin.extract_band_batch(jg, jnp.asarray(c), 32, jnp.asarray(w))
    got = tpt.extract_batch(tg, torch.as_tensor(c), 32, torch.as_tensor(w))
    np.testing.assert_array_equal(got.x0.numpy(), np.asarray(bp.x0))
    np.testing.assert_array_equal(got.y0.numpy(), np.asarray(bp.y0))
    roff, coff = np.asarray(bp.roff), np.asarray(bp.coff)
    for i in range(N):
        win = (slice(roff[i], roff[i] + 32), slice(coff[i], coff[i] + 32))
        # one rounding fewer on lever cells (the fused multiply-add): at most
        # an ulp of the product plus one of the sum, both below 1e-7 here
        np.testing.assert_allclose(got.values[i].numpy(), np.asarray(bp.values[i])[win],
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(got.ceil[i].numpy(), np.asarray(bp.ceil[i])[win])


def _scan_inputs(rng, k=17, spread=0.8):
    c, w = _centers(rng), _weights(rng)
    px = (c[:, 0:1] + rng.uniform(-spread, spread, (N, k))).astype(np.float32)
    py = (c[:, 1:2] + rng.uniform(-spread, spread, (N, k))).astype(np.float32)
    return c, w, px, py


def test_measure_scandots_matches(rng):
    jg, tg = _grids(rng, ceiling=False)
    c, w, px, py = _scan_inputs(rng)
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.as_tensor(a)
    ref = jpt.measure_scandots_batch(jg, j(c), 34, j(w), j(px), j(py))
    got = tpt.measure_scandots_batch(tg, t(c), 34, t(w), t(px), t(py))
    assert got.dtype == torch.float32 and got.shape == (N, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # points outside the window clip into it, so the lookup never leaves the grid
    far = tpt.measure_scandots_batch(tg, t(c), 34, t(w), t(px * 3.0), t(py * 3.0))
    np.testing.assert_array_equal(
        far.numpy(), np.asarray(jpt.measure_scandots_batch(jg, j(c), 34, j(w), j(px * 3.0),
                                                           j(py * 3.0))))


def test_measure_scandots_matches_pallas_kernel(world, monkeypatch):
    """Against the TPU kernel K3 replaces (measure_scandots_band, interpret
    mode), on the obstacle course with window centres on its goal
    waypoints, so that layer and lever cells are under the scans."""
    monkeypatch.setenv("AGILITY_WINDOWS", "interpret")
    rng = np.random.default_rng(5)
    kw = dict(hscale=world.hscale, origin_xy=world.origin, layer_id=world.layer_id,
              lever=world.lever)
    jg = jwin.attach_bands(jhf.from_numpy(world.height, **kw), scan_size=34)
    tg = thf.from_numpy(world.height, device="cpu", **kw)
    c = world.goals[:, :, :2].reshape(-1, 2).astype(np.float32)[:16]
    n = c.shape[0]
    w = np.stack([rng.uniform(0.05, 0.2, n), rng.uniform(0.4, 0.55, n),
                  rng.uniform(-0.17, 0.17, n)], -1).astype(np.float32)
    px = (c[:, 0:1] + rng.uniform(-0.7, 0.7, (n, 132))).astype(np.float32)
    py = (c[:, 1:2] + rng.uniform(-0.7, 0.7, (n, 132))).astype(np.float32)
    ref = jwin.measure_scandots_band(jg, jnp.asarray(c), 34, jnp.asarray(w),
                                     jnp.asarray(px), jnp.asarray(py))
    got = tpt.measure_scandots_batch(tg, torch.as_tensor(c), 34, torch.as_tensor(w),
                                     torch.as_tensor(px), torch.as_tensor(py))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the scans cross movable-layer and lever cells
    r, col = tpt.scandot_nodes(tg, torch.as_tensor(c), 34, torch.as_tensor(px),
                               torch.as_tensor(py))
    assert int((tg.layer_id[r, col] != 0).sum()) > 0 and int((tg.lever[r, col] != 0).sum()) > 0


def test_kernel_wrappers_take_the_plain_version_on_cpu(rng):
    """On CPU tensors K2 and K3 return their plain versions' results and
    launch nothing; a tensor on any other non-CUDA device raises."""
    _, tg = _grids(rng)
    c, w, px, py = (torch.as_tensor(a) for a in _scan_inputs(rng))
    before = (k2.terrain_window.launches, k3.scandots.launches)
    p = k2.terrain_window(tg, c, 32, w)
    ref = tpt.extract_batch(tg, c, 32, w)
    for f in ("values", "ceil", "x0", "y0"):
        assert torch.equal(getattr(p, f), getattr(ref, f)), f
    assert p.values.shape == (N, 32, 32) and p.x0.dtype == torch.int64
    s = k3.scandots(tg, c, 34, w, px, py)
    assert torch.equal(s, tpt.measure_scandots_batch(tg, c, 34, w, px, py))
    assert (k2.terrain_window.launches, k3.scandots.launches) == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k2.terrain_window(tg, c.to("meta"), 32, None)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k3.scandots(tg, c.to("meta"), 34, None, px.to("meta"), py.to("meta"))
    for mod in (k2, k3):
        assert mod.TPU_KERNEL.startswith("agility_tpu/physics/windows.py:")
        assert mod.SOURCE.startswith("agility_tpu_torch/csrc/")


_ALL = ("height", "lever", "layer_id", "ceiling", "ceiling_layer")


def _check_ring(cfg, P, W, surfaces, n, sms, per_sm):
    """The rules the window kernels' launchers check again for the staged
    design: boxes of whole 16-byte rows wide enough to start at column
    y0 & ~3; float32 surfaces by TMA (whose row pitch must be a multiple of
    16 bytes), the int8 tags by cp.async words; 128-byte box slots; the
    shared memory within what a block can use; the persistent grid."""
    bw = cfg["bw"]
    assert P + 3 <= bw < P + 7 and (4 * bw) % 16 == 0 and (4 * W) % 16 == 0
    want = {s: "tma" if s in ("height", "lever", "ceiling") else "cp.async" for s in surfaces}
    assert cfg["routes"] == want and cfg["staged"] == 1
    box, tag = -(-P * bw * 4 // 128) * 128, -(-P * bw // 128) * 128
    stage = sum(box if r == "tma" else tag for r in want.values())
    assert cfg["smem"] == k2.ALIGN_PAD + k2.STAGES * stage + k2.RING_BYTES
    assert cfg["smem"] <= 227 * 1024
    assert cfg["grid"] == max(1, min(n, sms * per_sm))


@pytest.mark.parametrize("W", [128, 130, 1800])
@pytest.mark.parametrize("P", [1, 5, 24, 32, 34, 35])
def test_terrain_window_launch_config(P, W):
    """K2's launch parameters, for every surface set a caller passes: a
    thread per 4 window cells in whole warps; the staged design (TMA only
    where the row pitch is a multiple of 16 bytes) where W % 4 == 0, else
    one block per env with plain loads."""
    for surfaces in (("height",), ("height", "ceiling"), _ALL):
        for n, sms, per_sm in ((1, 132, 6), (6144, 132, 6), (1000, 132, 16)):
            cfg = k2.launch_config(n, P, W, surfaces, sms, per_sm)
            assert cfg["threads"] % 32 == 0 and cfg["threads"] <= k2.MAX_THREADS
            assert 4 * cfg["threads"] >= P * P > 4 * (cfg["threads"] - 32)
            if W % 4 == 0:
                _check_ring(cfg, P, W, surfaces, n, sms, per_sm)
            else:
                assert cfg["routes"] == {s: "plain" for s in surfaces}
                assert (cfg["grid"], cfg["smem"], cfg["staged"]) == (n, 0, 0)
    with pytest.raises(ValueError, match="windows of"):
        k2.launch_config(1, k2.MAX_SIZE + 1, W, ("height",), 132, 1)


@pytest.mark.parametrize("W", [128, 130, 1800])
@pytest.mark.parametrize("P", [1, 5, 24, 32, 34, 35])
def test_scandots_launch_config(P, W):
    """K3's launch parameters: a warp an env, 8 envs a block, a group of
    up to 160 points a warp, no shared memory, every surface gathered from
    the grid whatever its width (the parameters do not depend on W); a
    window of one cell has no +x/+y neighbour and is refused."""
    g = _grids(np.random.default_rng(0))[1]
    w = torch.zeros((1, 3))
    assert k3.used_surfaces(g, w) == (("height", "lever", "layer_id"), 2)
    assert k3.floor_inputs(g, w)[:2] == (g.lever, g.layer_id)
    assert k3.used_surfaces(g, w[:, :1]) == (("height", "lever"), 0)
    assert k3.used_surfaces(g, None) == (("height",), 0)
    assert k3.ROUTE == "gather"
    for n, K in ((1, 132), (6144, 132), (1000, 33), (7, 300)):
        if P < 2:
            with pytest.raises(ValueError, match="at least 2 cells"):
                k3.launch_config(n, K, P)
            continue
        cfg = k3.launch_config(n, K, P)
        assert cfg == dict(threads=32 * k3.ENVS_PER_BLOCK, grid=-(-n // k3.ENVS_PER_BLOCK),
                           point_groups=-(-K // (32 * k3.GROUP)))
        assert cfg["threads"] == 256 and 32 * k3.GROUP * cfg["point_groups"] >= K
