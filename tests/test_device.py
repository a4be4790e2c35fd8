"""Device selection: the DP path, the backend guard, the compile cache,
card pinning for multi-process launches, and chip_smoke.py's contract."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import FIXTURES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,kernel,meta,interpret", [
    ("gpu", True, True, False),
    ("cpu", False, False, True),
])
def test_dp_path_choice(monkeypatch, backend, kernel, meta, interpret):
    """The GPU takes the Triton kernel on the device-metadata path, with
    no probe and no subprocess; the CPU takes the XLA program on host
    tiles, and would run the kernel only interpreted."""
    import jax

    from compseed.options import MemOptions
    from compseed.ops.bsw import BswRunner

    def no_subprocess(*a, **k):
        raise AssertionError("kernel choice must not start a process")
    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    opt = MemOptions()
    r = BswRunner(opt, np.array(opt.mat))
    assert (r.kernel, r.meta, r.interpret) == (kernel, meta, interpret)


def test_dp_imports_only_gpu_pallas():
    """The DP reaches Pallas only through the GPU routes."""
    import compseed.ops.bsw  # noqa: F401
    import compseed.ops.bsw_triton  # noqa: F401
    pallas = {m for m in sys.modules
              if m.startswith("jax.experimental.pallas.")}
    assert pallas <= {"jax.experimental.pallas.triton",
                      "jax.experimental.pallas.mosaic_gpu"}


@pytest.mark.parametrize("backend,env,ok", [
    ("gpu", "", True),
    ("cpu", "cpu", True),
    ("cpu", "", False),
    ("cpu", "cuda,cpu", False),
    ("rocm", "cpu", False),
])
def test_require_gpu(monkeypatch, backend, env, ok):
    import jax

    from compseed.device import require_gpu
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setenv("JAX_PLATFORMS", env)
    if ok:
        assert require_gpu("t") == backend
    else:
        with pytest.raises(RuntimeError, match="not 'gpu'"):
            require_gpu("t")


def test_mem_device_refuses_unrequested_cpu(monkeypatch, tmp_path, capsys):
    """``mem --engine device`` on a backend that is not the GPU, without
    JAX_PLATFORMS=cpu, stops with an error instead of running."""
    from compseed import cli
    monkeypatch.setenv("JAX_PLATFORMS", "")
    rc = cli.main(["mem", os.path.join(FIXTURES, "tiny"),
                   os.path.join(FIXTURES, "reads.fq"), "--engine",
                   "device", "-o", str(tmp_path / "o.sam")])
    assert rc == 2
    assert "not 'gpu'" in capsys.readouterr().err
    assert not (tmp_path / "o.sam").exists()


@pytest.mark.parametrize("set_env", [True, False])
def test_compilation_cache_dir(tmp_path, set_env):
    """JAX_COMPILATION_CACHE_DIR places the persistent cache when set;
    otherwise it is the checkout's fixed .jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, compseed.ops; "
         "print(jax.config.values['jax_compilation_cache_dir'])"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    got = out.stdout.strip().splitlines()[-1]
    want = str(tmp_path) if set_env else os.path.join(ROOT, ".jax_cache")
    assert got == want


@pytest.mark.parametrize("pid,n_cards,card", [
    (0, 4, 0), (3, 4, 3), (5, 4, 1), (2, 1, 0), (1, 0, 0)])
def test_card_for_process(pid, n_cards, card):
    from compseed.parallel.distributed import card_for_process
    assert card_for_process(pid, n_cards) == card


@pytest.mark.parametrize("coordinator", [None, "localhost:12355"])
def test_init_distributed_pins_one_card(monkeypatch, coordinator):
    """Each process of a multi-process launch opens only its own card,
    chosen from its process id before the backend starts."""
    import jax

    import compseed.device as dev
    from compseed.parallel import distributed as dist
    monkeypatch.setattr(dev, "local_card_count", lambda: 4)
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.setdefault(k, v))
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    assert dist.init_distributed(coordinator, 4, 2) == (2, 4)
    if coordinator:
        assert seen["local_device_ids"] == [2]
        assert seen["process_id"] == 2
    else:
        assert seen == {"jax_cuda_visible_devices": "2"}


def test_init_distributed_single_process_touches_nothing(monkeypatch):
    import jax

    from compseed.parallel import distributed as dist
    monkeypatch.setattr(jax.config, "update", lambda *a: pytest.fail())
    assert dist.init_distributed(None, 1, 0) == (0, 1)


@pytest.mark.parametrize("line,name,limit", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3",
     "700.00 W"),
    ("NVIDIA H100 PCIe, 350.00 W\n", "NVIDIA H100 PCIe", "350.00 W"),
    ("Some, Card, With Commas, 500.00 W", "Some, Card, With Commas",
     "500.00 W"),
])
def test_parse_card(line, name, limit):
    from compseed.device import parse_card
    assert parse_card(line) == (name, limit)


def test_parse_card_rejects_garbage():
    from compseed.device import parse_card
    with pytest.raises(ValueError):
        parse_card("no comma here")


def test_chip_smoke_result_line():
    sys.path.insert(0, ROOT)
    import chip_smoke

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"
    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_chip_smoke_fallback_report():
    sys.path.insert(0, ROOT)
    import chip_smoke
    err = ("[mem] processed 10 reads\n"
           "Fallbacks:   0 whole-chunk reruns, 7 spliced reads\n")
    assert chip_smoke.fallbacks(err) == (0, 7)
    with pytest.raises(RuntimeError):
        chip_smoke.fallbacks("nothing")


def test_chip_smoke_fails_without_gpu(capsys):
    """No GPU: non-zero exit and no result line."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    assert chip_smoke.main([]) == 1
    assert capsys.readouterr().out == ""
