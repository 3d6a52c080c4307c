"""scripts/diag_convergence_torch.py (the port's convergence diagnostic) on
the CPU, against scripts/diag_convergence.py (the JAX package's).

``--device cpu --quick --batch 32`` runs the plain path's rows at N=20 on
the JAX script's batch (the same numpy draws): its ground truth, 60 rounds
at CG-25 without the tail, matches the JAX script's ``run(...)`` of that
budget on the XLA path scenario by scenario within 1e-3 relative (float32
sums in another order over 60 rounds, at a converged minimum), and its rows
carry the JAX script's columns. Without a card and without ``--device cpu``
the script exits non-zero.
"""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cpu_rows_match_the_jax_script(capsys):
    port = _load("diag_convergence_torch")
    out = port.main(["--device", "cpu", "--quick", "--batch", "32"])
    printed = capsys.readouterr().out

    jax_script = _load("diag_convergence")
    config, prob = jax_script.make_batch(32)
    gt = jax_script.run(config, prob, "xla", max_iterations=60, cg_iterations=25,
                        tail_iterations=0)
    want = np.asarray(gt.cost, np.float64)
    assert out["ground_truth"].shape == (32,)
    np.testing.assert_allclose(out["ground_truth"], want, rtol=1e-3)

    header = next(ln for ln in printed.splitlines() if ln.startswith("method"))
    cols = [header.index(c) for c in ("method", "budget", "conv", "p95 excess", "max excess",
                                      "conv-cohort p95")]
    assert cols == sorted(cols)
    assert [r["budget"] for r in out["rows"]] == ["ship 12+8@25", "ship+restart 20"]
    for r in out["rows"]:
        assert r["method"] == "torch" and 0.0 <= r["conv"] <= 1.0
        assert np.isfinite([r["p95"], r["max"], r["ms"]]).all()
        assert r["max"] >= r["p95"]
    assert "cpu, host clock" in printed


@pytest.mark.parametrize("args", [[], ["--device", "cuda:0"]])
def test_without_a_card_it_exits_non_zero(args):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "diag_convergence_torch.py"),
                        "--batch", "4", *args], capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert "ground truth" not in r.stdout
