"""The window copies D and E (agility_tpu_torch/kernels/window_dma.py) and the
port of tools/bench_windows.py on the CPU, against the JAX tool on a small
world (5 x 240 x 240, 16 envs) at its three shapes: D's plain version equals
JAX's B (banded_gather_kfirst) transposed, E's equals JAX's
pallas_band_dma in interpret mode, and the port's A, B and C equal JAX's,
all bit for bit.

tools/bench_windows.py reads N from BENCH_ENVS and sets a compilation
cache under ~ when it is imported, so the JAX side runs in a subprocess
with JAX_PLATFORMS=cpu, BENCH_ENVS set and HOME a temporary directory; it
writes its outputs to an npz."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from agility_tpu_torch.kernels import launch_counts, window_dma
from agility_tpu_torch.tools import bench_windows as tbw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 16, 240, 240

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, "tools")
    import bench_windows as bw
    import jax
    import jax.numpy as jnp
    assert bw.N == {N}
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, {H} - 80, {N}).astype(np.int32)
    y0 = rng.integers(0, {W} - 80, {N}).astype(np.int32)
    out = dict(x0=x0, y0=y0)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    for dt, K, P, stride in {SHAPES}:
        dtype = jnp.float32 if dt == "f32" else jnp.bfloat16
        g = jnp.asarray(np.random.default_rng(1).normal(0, 0.3, (K, {H}, {W}))
                        .astype(np.float32)).astype(dtype)
        g_hwk = jnp.transpose(g, (1, 2, 0))
        key = f"{{dt}}_{{P}}"
        out["g_" + key] = f32(g)
        run = lambda fn: f32(jax.jit(fn)(x0, y0))
        out["A_" + key] = run(bw.banded_gather(g_hwk, P, 64, stride))
        out["B_" + key] = run(bw.banded_gather_kfirst(g, P, 64, stride))
        out["C_" + key] = run(bw.banded_gather_laneconcat(g, P, 64, stride))
        out["E_" + key] = run(bw.pallas_band_dma(g, P, 64, stride, EB=8, interpret=True))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_windows")
    path = str(d / "out.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "BENCH_ENVS": str(N), "HOME": str(d)}
    script = JAX_SCRIPT.format(N=N, H=H, W=W, SHAPES=repr(tbw.SHAPES))
    res = subprocess.run([sys.executable, "-c", script, path], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(path))


def _inputs(jax_out, dt, P):
    g = torch.from_numpy(jax_out[f"g_{dt}_{P}"]).to(tbw.DTYPES[dt])
    x0 = torch.from_numpy(jax_out["x0"])
    y0 = torch.from_numpy(jax_out["y0"])
    return g, x0, y0


def _same(got, want):
    """Bit for bit: the values as float32 (exact for bfloat16) with their bits."""
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


SHAPE_IDS = [f"{dt}-K{K}-P{P}" for dt, K, P, _ in tbw.SHAPES]


@pytest.mark.parametrize("shape", tbw.SHAPES, ids=SHAPE_IDS)
def test_per_env_windows_equal_jax_kfirst_gather(jax_out, shape):
    """D's window at the exact origin is JAX's B, (K, N, P, P) -> (N, K, P, P)."""
    dt, K, P, stride = shape
    g, x0, y0 = _inputs(jax_out, dt, P)
    got = window_dma.per_env_windows(g, x0, y0, P)
    assert got.dtype == g.dtype and got.shape == (N, K, P, P)
    _same(got, np.ascontiguousarray(jax_out[f"B_{dt}_{P}"].transpose(1, 0, 2, 3)))


@pytest.mark.parametrize("shape", tbw.SHAPES, ids=SHAPE_IDS)
def test_band_windows_equal_jax_pallas_band_dma(jax_out, shape):
    """E's slab of the band stack is JAX's pallas_band_dma (interpret mode)."""
    dt, K, P, stride = shape
    g, x0, y0 = _inputs(jax_out, dt, P)
    al = window_dma.sublane(g.dtype)
    G2 = window_dma.band_stack(g, P, 64, stride, al)
    got = window_dma.band_windows(G2, x0, y0, P, 64, stride, al)
    assert got.dtype == g.dtype
    _same(got, jax_out[f"E_{dt}_{P}"])


@pytest.mark.parametrize("shape", tbw.SHAPES, ids=SHAPE_IDS)
def test_port_formulations_equal_jax(jax_out, shape):
    """The port's A, B and C (plain torch) equal the JAX tool's, and D's
    window is B's; every row of the shape runs."""
    dt, K, P, stride = shape
    g, x0, y0 = _inputs(jax_out, dt, P)
    _same(tbw.banded_gather(g.permute(1, 2, 0).contiguous(), P, 64, stride)(x0, y0),
          jax_out[f"A_{dt}_{P}"])
    _same(tbw.banded_gather_kfirst(g, P, 64, stride)(x0, y0), jax_out[f"B_{dt}_{P}"])
    _same(tbw.banded_gather_laneconcat(g, P, 64, stride)(x0, y0), jax_out[f"C_{dt}_{P}"])


def test_per_env_windows_zero_outside_the_grid():
    """D never reads outside G: cells off the grid are zero, the rest G's."""
    g = torch.arange(2 * 6 * 7, dtype=torch.float32).reshape(2, 6, 7) + 1
    x0 = torch.tensor([-2, 4, 0, 5], dtype=torch.int32)
    y0 = torch.tensor([-1, 5, 0, -3], dtype=torch.int32)
    out = window_dma.per_env_windows(g, x0, y0, 3, 4)
    assert out.shape == (4, 2, 3, 4)
    for n in range(4):
        for k in range(2):
            for i in range(3):
                for j in range(4):
                    x, y = int(x0[n]) + i, int(y0[n]) + j
                    want = g[k, x, y] if 0 <= x < 6 and 0 <= y < 7 else 0.0
                    assert out[n, k, i, j] == want


@pytest.mark.parametrize("dt,K,P,bw,stage_bytes,stages,smem", [
    ("f32", 5, 32, 36, 23_040, 2, 46_240), ("bf16", 3, 56, 64, 21_504, 2, 43_168),
    ("bf16", 3, 36, 48, 10_368, 2, 20_896)])
def test_per_env_config_at_the_window_shapes(dt, K, P, bw, stage_bytes, stages, smem):
    """D takes "tma" at the window A/B's three shapes on the 1800 x 1800
    world: boxes bw = Pc + v - 1 rounded up to v = 16 / element size, a
    stage of bw * P * K elements, two stages, the shared memory of the
    pad, the stages and the barriers, and a grid of persistent blocks."""
    dtype = tbw.DTYPES[dt]
    cfg = window_dma.per_env_config(6144, K, 1800, 1800, P, P, dtype, 132, 2)
    assert cfg == dict(route="tma", threads=256, grid=264, bw=bw, stage_bytes=stage_bytes,
                       stages=stages, smem=smem)
    assert window_dma.per_env_config(100, K, 1800, 1800, P, P, dtype, 132, 2)["grid"] == 100
    assert window_dma.per_env_config(0, K, 1800, 1800, P, P, dtype, 132, 2)["grid"] == 1


@pytest.mark.parametrize("dtype,W,base,route", [
    (torch.float32, 208, 0, "tma"), (torch.float32, 204, 0, "tma"),
    (torch.float32, 203, 0, "rows"), (torch.float32, 202, 0, "rows"),
    (torch.float32, 208, 4, "rows"), (torch.float32, 208, 512, "tma"),
    (torch.bfloat16, 208, 0, "tma"), (torch.bfloat16, 1800, 0, "tma"),
    (torch.bfloat16, 204, 0, "rows"), (torch.bfloat16, 203, 0, "rows"),
    (torch.bfloat16, 208, 2, "rows"), (torch.bfloat16, 208, 8, "rows")])
def test_per_env_config_route_by_width_dtype_alignment(dtype, W, base, route):
    """"tma" needs a row pitch of whole 16-byte units (W % 4 == 0 in float32,
    W % 8 == 0 in bfloat16) and a 16-byte aligned base; anything else takes
    "rows", one block an env and no shared memory."""
    cfg = window_dma.per_env_config(50, 3, 200, W, 32, 32, dtype, 132, 2, base_ptr=base)
    assert cfg["route"] == route
    if route == "rows":
        assert cfg == window_dma.rows_config(50) == dict(
            route="rows", threads=256, grid=50, bw=0, stage_bytes=0, stages=0, smem=0)


@pytest.mark.parametrize("K,P,Pc,dtype,route,bw,stages", [
    (5, 32, 35, torch.float32, "tma", 40, 2),        # Pc not a multiple of v: bw 35 + 3 -> 40
    (3, 56, 36, torch.bfloat16, "tma", 48, 2),
    (1, 3, 3, torch.float32, "tma", 8, 2),           # narrower than a vector
    (256, 4, 4, torch.float32, "tma", 8, 2),         # K at the box limit
    (257, 4, 4, torch.float32, "rows", 0, 0),        # K past it
    (1, 257, 4, torch.float32, "rows", 0, 0),        # P past it
    (1, 4, 253, torch.float32, "tma", 256, 2),       # bw 256: at the limit
    (1, 4, 254, torch.float32, "rows", 0, 0),        # bw 260
    (1, 4, 249, torch.bfloat16, "tma", 256, 2),
    (1, 4, 250, torch.bfloat16, "rows", 0, 0),       # bw 264
    (2, 100, 100, torch.float32, "tma", 104, 2),     # 83,200 B a stage: two fit
    (3, 100, 100, torch.float32, "rows", 0, 0),      # 124,800 B: not two
    (1, 113, 253, torch.float32, "tma", 256, 2),     # 115,712 B: two fill 227 KB
    (1, 114, 253, torch.float32, "rows", 0, 0),      # 116,736 B: one row too many
    (2, 64, 64, torch.bfloat16, "tma", 72, 2),
    (4, 128, 128, torch.bfloat16, "rows", 0, 0)])    # 139,264 B
def test_per_env_config_limits(K, P, Pc, dtype, route, bw, stages):
    """Box limits (256 in each dim of a TMA box) and shared memory (at least
    two stages in 227 KB): past either, "rows"."""
    cfg = window_dma.per_env_config(10, K, 2000, 2000, P, Pc, dtype, 132, 1)
    esz = 4 if dtype == torch.float32 else 2
    assert (cfg["route"], cfg["bw"], cfg["stages"]) == (route, bw, stages)
    if route == "tma":
        pitch = -(-cfg["stage_bytes"] // 128) * 128
        assert cfg["stage_bytes"] == bw * P * K * esz
        assert cfg["smem"] == 128 + stages * pitch + 32 <= window_dma.MAX_SMEM
        assert cfg["grid"] == 10


def test_band_windows_clip_as_jax():
    """E's origins are JAX's clips of the floor divisions, off the grid too."""
    g = torch.randn(2, 40, 50)
    P, band, stride, al = 8, 16, 8, 8
    G2 = window_dma.band_stack(g, P, band, stride, al)
    geo = window_dma.band_geometry(40, 50, 2, P, band, stride, al)
    assert G2.shape == (geo["nb"], geo["Hp"], geo["KB"]) == (6, 40, 128)
    x0 = torch.tensor([-9, 0, 7, 33, 39, 100], dtype=torch.int32)
    y0 = torch.tensor([-1, 3, 17, 45, 200, -30], dtype=torch.int32)
    out = window_dma.band_windows(G2, x0, y0, P, band, stride, al)
    P8 = geo["P8"]
    for n in range(6):
        x0a = min(max((int(x0[n]) // al) * al, 0), geo["Hp"] - P8)
        yb = min(max(int(y0[n]) // stride, 0), geo["nb"] - 1)
        assert torch.equal(out[n], G2[yb, x0a:x0a + P8])
        c0 = yb * stride
        assert torch.equal(out[n, :, :band][:, :50 - c0], g[0, x0a:x0a + P8, c0:c0 + band])
    with pytest.raises(ValueError):
        window_dma.band_windows(G2[:, :P8 - 1], x0, y0, P, band, stride, al)


def test_window_kernels_counted():
    """launch_counts lists D and E; on the CPU nothing launches."""
    before = launch_counts()
    assert {"per_env_windows", "band_windows"} <= set(before)
    g = torch.randn(1, 20, 20)
    xy = torch.zeros(3, dtype=torch.int32)
    window_dma.per_env_windows(g, xy, xy, 4)
    assert launch_counts() == before


def _module_value(tree, name):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return node.value
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets[0].elts):
            return node.value
    raise KeyError(name)


def test_defaults_and_labels_are_the_jax_tools():
    """The port's world, envs, steps, runs, shapes and labels are the JAX
    tool's (read with ast): H = W = 1800, BENCH_ENVS 6144, T = 24, 3 timed
    runs, f32 K 5 P 32 at stride 32 and bf16 K 3 P 56 / 36 at stride 8 /
    16, band 64; A's and C's labels as JAX prints them, E's without EB."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "bench_windows.py")).read())
    assert _module_value(tree, "H").value == tbw.H == tbw.W == 1800
    assert ast.literal_eval(_module_value(tree, "T")) == tbw.T
    envs = _module_value(tree, "N")
    assert ast.literal_eval(envs.args[0].args[1]) == "6144"
    assert os.environ.get("BENCH_ENVS") or tbw.N == 6144
    timed = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "timed")
    kw = dict(zip([a.arg for a in timed.args.kwonlyargs], timed.args.kw_defaults))
    assert ast.literal_eval(kw["iters"]) == tbw.ITERS
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "timed"]
    labels = {}
    for c in calls:
        label = next(k.value for k in c.keywords if k.arg == "label")
        inner = c.args[0]
        name, (_, _, band, stride) = inner.func.id, inner.args
        labels[name, ast.unparse(stride)] = label
    f32 = ast.literal_eval(next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                                and ast.unparse(n.targets[0]) in ("K, P", "(K, P)")))
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For)
                and ast.unparse(n.target) == "P")
    ifexp = next(n for n in ast.walk(loop) if isinstance(n, ast.IfExp))
    want = [("f32", *f32, 32)] + [
        ("bf16", 3, P, ifexp.body.value if P == ifexp.test.comparators[0].value
         else ifexp.orelse.value) for P in ast.literal_eval(loop.iter)]
    assert list(tbw.SHAPES) == want
    assert all(ast.literal_eval(c.args[0].args[2]) == tbw.BAND for c in calls
               if isinstance(c.args[0].args[2], ast.Constant))
    for dt, K, P, stride in tbw.SHAPES:
        env = {"K": K, "P": P, "eb": 8}
        got = [label for label, _ in tbw.formulations(dt, K, P, stride, "cpu", 90, 90)]
        assert len(got) == 5 and [g[0] for g in got] == list("ABCDE")
        a = labels.get(("banded_gather", "32" if dt == "f32" else "stride"))
        assert got[0] == eval(compile(ast.Expression(a), "label", "eval"), env)
        if dt == "f32":
            c = labels["banded_gather_laneconcat", "32"]
            assert got[2] == eval(compile(ast.Expression(c), "label", "eval"), env)
        e = labels["pallas_band_dma", "32" if dt == "f32" else "stride"]
        jax_e = eval(compile(ast.Expression(e), "label", "eval"), env)
        assert got[4] == jax_e.replace("pallas ", "").replace(" EB8", "")


def test_tool_runs_on_cpu():
    """The whole tool (its numerics check and every row at every shape) at
    8 envs, T = 2, one round, on a 120 x 120 world."""
    rows = tbw.bench("cpu", n=8, T=2, iters=1, H=120, W=120)
    assert [r["label"][0] for r in rows] == list("ABCDE") * 3
    assert all(r["ms"] > 0 and np.isfinite(r["ms"]) for r in rows)
    assert all(r["launches"]["per_env_windows"] == r["launches"]["band_windows"] == 0
               for r in rows)
