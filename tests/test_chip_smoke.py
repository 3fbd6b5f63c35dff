"""chip_smoke.py's phases at tiny sizes on the CPU (kernels in interpret
mode), its refusal to run without a GPU, and the compile-cache rule.

On the card itself the script is run as ``python chip_smoke.py``; the
``gpu``-marked test below does that when the suite runs on a GPU machine.
"""

import importlib.util
import os
import pathlib

import jax
import pytest

from pde_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestDeviceCheck:
    def test_refuses_a_cpu(self, smoke):
        with pytest.raises(SystemExit) as exc:
            smoke.phase_device(require="gpu", smi=lambda: "unused")
        assert "no gpu device" in str(exc.value)

    def test_main_exits_nonzero_without_gpu(self, smoke, capsys):
        with pytest.raises(SystemExit) as exc:
            smoke.main([])
        assert exc.value.code not in (0, None)
        assert '"ok"' not in capsys.readouterr().out

    def test_reports_device_and_card(self, smoke, capsys):
        out = smoke.phase_device(require="cpu", smi=lambda: "Card X, 1.00 W")
        assert out["platform"] == "cpu"
        assert out["count"] == len(jax.devices())
        printed = capsys.readouterr().out.splitlines()
        assert "Card X, 1.00 W" in printed
        assert printed[-1].startswith("phase device: ")


@pytest.fixture
def float32_default():
    """The card runs with x64 off; the suite runs with it on."""
    with jax.enable_x64(False):
        yield


@pytest.mark.usefixtures("float32_default")
class TestPhasesTiny:
    def test_calibration(self, smoke):
        out = smoke.phase_calibration(maxiter=4, popsize=5, n_strikes=5,
                                      n_maturities=2, param_tol=10.0,
                                      rmse_tol=1.0, reps=1)
        assert out["n_quotes"] == 10

    def test_service_checks_every_answer(self, smoke):
        out = smoke.phase_service(waves=(5, 40), require_buckets=(8, 128))
        assert out["n_requests"] == 45
        assert sum(out["batch_sizes"]) == 45

    def test_service_fails_on_wrong_answers(self, smoke, monkeypatch):
        from pde_tpu.serving import BatchPricer

        real = BatchPricer.finalize

        def off_by_one(handle):
            return [type(r)(r.price + 1.0) for r in real(handle)]

        monkeypatch.setattr(BatchPricer, "finalize", staticmethod(off_by_one))
        with pytest.raises(smoke.CheckFailed):
            smoke.phase_service(waves=(4,), require_buckets=())

    def test_heston_adi(self, smoke):
        out = smoke.phase_heston_adi(B=3, n_spot=16, n_vol=8, n_time=3,
                                     n_f64=2, interpret=True, reps=1)
        assert out["max_abs_err_vs_f64"] < out["tol"]

    def test_local_vol(self, smoke):
        out = smoke.phase_local_vol(B=5, n_space=24, n_time=4, n_k=6, n_t=3,
                                    n_f64=2, interpret=True, reps=1)
        assert out["max_abs_err_vs_scan_f32"] < out["tol"]

    def test_sabr(self, smoke):
        out = smoke.phase_sabr(reps=1)
        assert out["rmse"] < out["rmse_tol"]

    def test_f64_parity(self, smoke):
        """float64 is scoped inside the phase: it holds with x64 off."""
        out = smoke.phase_f64_parity()
        assert max(out["max_abs_err"].values()) < 1e-8

    def test_four_on_virtual_devices(self, smoke):
        out = smoke.phase_four(n_devices=4, n_surfaces=4, n_quotes=8,
                               maxiter=3, popsize=4, n_paths=4 * 4096,
                               lsm_paths=4 * 2048)
        assert out["shards_on"] == sorted({d.id for d in jax.devices()[:4]})


class TestCompileCache:
    def test_directory_in_force_is_kept(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        # conftest already put the suite's cache in force
        assert compile_cache.enable_compile_cache() == \
            jax.config.jax_compilation_cache_dir
        assert calls == []

    @pytest.mark.parametrize("env, arg, expected", [
        ("/elsewhere", None, "/elsewhere"),
        ("/elsewhere", "/given", "/elsewhere"),
        (None, None, str(ROOT / ".jax_cache")),
        (None, "/given", "/given"),
    ])
    def test_fresh_process(self, env, arg, expected):
        """In a fresh process: the environment variable wins and nothing is
        set; otherwise the given directory, else <repo>/.jax_cache."""
        import subprocess
        import sys

        penv = {k: v for k, v in os.environ.items()
                if k != "JAX_COMPILATION_CACHE_DIR"}
        penv["JAX_PLATFORMS"] = "cpu"
        if env:
            penv["JAX_COMPILATION_CACHE_DIR"] = env
        code = ("import jax; from pde_tpu.utils.compile_cache import "
                "enable_compile_cache as e; "
                f"print(e({arg!r}), jax.config.jax_compilation_cache_dir)")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=penv, capture_output=True, text=True,
                             timeout=120, check=True).stdout.split()
        assert out == [expected, expected]

    def test_repo_cache_is_ignored_by_git(self):
        lines = (ROOT / ".gitignore").read_text().splitlines()
        assert ".jax_cache/" in lines


@pytest.fixture
def nvidia_gpu():
    """Skip unless this machine has an NVIDIA GPU (decided at run time)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("no NVIDIA GPU here; run python chip_smoke.py on the card")


@pytest.mark.gpu
def test_chip_smoke_on_the_card(nvidia_gpu):
    import json
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=1200)
    assert done.returncode == 0, done.stderr[-2000:]
    last = json.loads(done.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
