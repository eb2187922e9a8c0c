"""Running on a GPU host: compile-cache placement, one card per worker
process, distributed bring-up, and chip_smoke.py's refusal to report
without a GPU."""

import os
import subprocess
import sys

import pytest

import photobundle_tpu
from photobundle_tpu import multi
from photobundle_tpu.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_in_checkout_without_variable():
    got = photobundle_tpu.compile_cache_dir({})
    assert got == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_left_to_jax_with_variable(tmp_path):
    assert photobundle_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) is None


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir_after_import(tmp_path, env_dir):
    """What a fresh process importing the package ends up with."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import photobundle_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want


def test_workers_get_one_card_each():
    envs = multi.worker_envs(3, ["0", "1", "2", "3"], {"A": "1"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2"]
    assert all(e["A"] == "1" for e in envs)


def test_more_workers_than_cards_refused():
    with pytest.raises(ValueError, match="one worker per card"):
        multi.worker_envs(3, ["0", "1"], {})


def test_cpu_workers_keep_their_environment():
    envs = multi.worker_envs(2, [], {"JAX_PLATFORMS": "cpu"})
    assert envs == [{"JAX_PLATFORMS": "cpu"}] * 2


@pytest.mark.parametrize("environ,want", [
    ({"JAX_PLATFORMS": "cpu"}, []),
    ({"JAX_PLATFORMS": "cuda", "CUDA_VISIBLE_DEVICES": "2,3"}, ["2", "3"]),
    ({"CUDA_VISIBLE_DEVICES": "-1"}, []),
])
def test_visible_gpus(environ, want):
    assert multi.visible_gpus(environ) == want


def test_distributed_bringup_opens_only_own_card(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh.jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    mesh.initialize_distributed("localhost:1234", 1, 0)       # one process
    assert calls == []
    mesh.initialize_distributed("localhost:1234", 4, 2)
    assert calls[-1] == dict(coordinator_address="localhost:1234",
                             num_processes=4, process_id=2,
                             local_device_ids=[2])
    mesh.initialize_distributed("localhost:1234", 2, 1, [2, 3])
    assert calls[-1]["local_device_ids"] == [2, 3]


def _no_ok_line(stdout: str) -> bool:
    return not any('"ok": true' in line for line in stdout.splitlines())


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)


def test_native_build_renames_a_finished_library_into_place(tmp_path,
                                                            monkeypatch):
    """Processes that start together may all build the native library;
    each compiles to a private file and renames it, so no process loads a
    library another is still writing."""
    from photobundle_tpu import native

    lib = tmp_path / "libpb_native.so"
    monkeypatch.setattr(native, "_LIB", str(lib))
    outputs = []

    def fake_compile(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        outputs.append(out)
        assert not lib.exists()               # nothing half-written in place
        with open(out, "wb") as f:
            f.write(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native.subprocess, "run", fake_compile)
    assert native._build() is None
    assert outputs and outputs[0] != str(lib)
    assert lib.read_bytes() == b"lib"
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]

    def failed_compile(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 1, "", "png.h: missing")

    lib.unlink()
    monkeypatch.setattr(native.subprocess, "run", failed_compile)
    assert "png.h" in native._build()
    assert list(tmp_path.iterdir()) == []
