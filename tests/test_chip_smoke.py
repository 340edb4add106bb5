"""The GPU smoke script and the measurement guards, exercised on the CPU.

Every phase function of ``chip_smoke.py`` runs here at toy size (64x48
frames, 128^3 map, 10 frames) and must pass its own checks; the device
check and both measurement scripts must refuse a CPU-only process.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# 64x48 frames of the loop scene at -c 1. The map is 128^3 (37.5 mm
# voxels): at 64^3 (75 mm) the raycast surface is too coarse for ICP's
# 2 cm residual gate and no frame tracks. The ATE bound is about one
# such voxel.
TOY = chip_smoke.Config(width=64, height=48, ratio=1, voxels=128,
                        frames=10, pyramid=(3, 2), preset_budget=512,
                        local_capacity=1024, ate_bound_m=0.04)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    meter = chip_smoke.CompileMeter()
    raw, gt = chip_smoke.make_data(TOY, str(tmp_path_factory.mktemp("d")))
    return meter, raw, gt


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_served_phase_toy(toy, field):
    meter, raw, gt = toy
    s = chip_smoke.served_phase(TOY, field, raw, gt, meter)
    assert s["frames"] == TOY.frames and all(s["tracked"][4:])
    assert s["ate"]["rmse"] < TOY.ate_bound_m


def test_fused_phase_toy(toy, capsys):
    meter, raw, gt = toy
    chip_smoke.fused_phase(TOY, raw, gt, meter)
    out = capsys.readouterr().out
    assert "fused vs stage-wise" in out and "memory_analysis" in out


def test_four_phase_toy(toy, capsys):
    meter, raw, gt = toy
    chip_smoke.four_phase(TOY, raw, gt, meter)
    assert "dist (4 devices) vs single" in capsys.readouterr().out


@pytest.mark.gpu
def test_toy_phases_on_gpu(gpu, toy):
    """The toy served and fused phases, compiled for the card."""
    meter, raw, gt = toy
    chip_smoke.served_phase(TOY, "tsdf", raw, gt, meter, str(gpu))
    chip_smoke.fused_phase(TOY, raw, gt, meter)


def test_pose_gaps_measure_translation_and_rotation():
    a = np.tile(np.eye(4), (2, 1, 1))
    b = a.copy()
    b[1, :3, 3] = (0.003, 0.004, 0.0)
    c, s = np.cos(np.radians(0.5)), np.sin(np.radians(0.5))
    b[1, :2, :2] = [[c, -s], [s, c]]
    dt, dr = chip_smoke._pose_gaps(a, b)
    np.testing.assert_allclose(dt, [0.0, 0.005], atol=1e-12)
    np.testing.assert_allclose(dr, [0.0, 0.5], atol=1e-6)
    cast = _raycast(np.zeros((4, 4, 3)), np.ones((4, 4), bool))
    with pytest.raises(AssertionError, match=r"'rotation deg': \[1\]"):
        chip_smoke._check_runs("t", [dict(cast, pose=p) for p in a],
                               [dict(cast, pose=p) for p in b])


def _raycast(vertex, valid):
    normal = np.zeros_like(vertex)
    normal[..., 2] = 1.0
    return {"vertex": vertex, "normal": normal, "valid": valid}


def test_raycast_gaps_measure_flips_vertices_and_normals():
    vertex = np.zeros((10, 10, 3))
    valid = np.ones((10, 10), bool)
    a = _raycast(vertex, valid)
    b = _raycast(vertex.copy(), valid.copy())
    b["valid"][0, :5] = False                 # 5 of 100 pixels flip
    b["vertex"][1:, :, 0] = 0.005             # slid along the plane
    b["vertex"][1:, :, 2] = 0.002             # 2 mm off it
    c, s = np.cos(np.radians(3.0)), np.sin(np.radians(3.0))
    b["normal"][...] = (0.0, s, c)            # tilted by 3 deg
    flip, v99, n99 = chip_smoke._raycast_gaps(a, b)
    assert flip == pytest.approx(0.05)
    assert v99 == pytest.approx(0.002 * c)
    assert n99 == pytest.approx(3.0, rel=1e-6)
    assert chip_smoke._raycast_gaps(a, a) == (0.0, 0.0, 0.0)
    none = _raycast(vertex, np.zeros((10, 10), bool))
    assert chip_smoke._raycast_gaps(none, none) == (0.0, 0.0, 0.0)
    pose = np.eye(4)
    with pytest.raises(AssertionError, match=r"'hit/miss flips %': \[0\]"):
        chip_smoke._check_runs("t", [dict(a, pose=pose)],
                               [dict(b, pose=pose)])


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.device_check()
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_exits_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    for line in p.stdout.splitlines():
        assert '"ok"' not in line and '"metric"' not in line


def test_smoke_alone_exits_nonzero(tmp_path):
    """Without the rest of the repo the script fails and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_compile_cache_honours_env(tmp_path):
    code = ("import jax; from supereight_tpu.utils import compilecache as c;"
            "d = c.enable();"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0);"
            "jax.jit(lambda x: x * 2)(1.0).block_until_ready(); print(d)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path), PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert os.listdir(tmp_path)


def test_compile_cache_default_is_repo_path(monkeypatch):
    from supereight_tpu.utils import compilecache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compilecache.enable() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        REPO, ".jax_cache")


@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("steps", [0, 1, 3, 7, 12])
def test_bounded_steps_matches_python_loop(steps, unroll):
    """Lanes need 0..9 steps; a finished lane is a fixed point."""
    from supereight_tpu.utils.loops import bounded_steps
    need = jnp.arange(10, dtype=jnp.int32)

    def body(c):
        x, n = c
        live = n < need
        return jnp.where(live, x * 1.5 + 1.0, x), jnp.where(live, n + 1, n)

    carry = (jnp.zeros(10), jnp.zeros(10, jnp.int32))
    got = jax.jit(lambda c: bounded_steps(
        body, c, steps, lambda c: jnp.any(c[1] < need),
        unroll=unroll))(carry)
    want = carry
    for _ in range(steps):
        want = body(want)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_card_lines_reads_nvidia_smi(monkeypatch):
    from supereight_tpu.utils import device

    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n\n")
    monkeypatch.setattr(device.subprocess, "run", fake_run)
    assert device.card_lines() == ["NVIDIA H100 80GB HBM3, 700.00 W"]
