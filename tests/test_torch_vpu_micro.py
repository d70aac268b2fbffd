"""The port's elementwise micro-benchmark against the JAX script's Pallas
pass (``scripts/exp_vpu_micro.py::run``, interpret mode), on the CPU, where
the port takes its plain version; and the port's entry point at a small
shape.

Tolerance: one bf16 ulp of the reference's magnitude, elementwise. Both
sides compute in fp32 and round once to bf16, but XLA may fuse or reorder
the fp32 operations (it contracts multiply-adds into FMAs; the port rounds
each operation) and the two exp implementations may differ in the last
fp32 bit, which can move a value across a bf16 rounding boundary. The four
polynomial variants add an absolute 2**-14: their Horner terms in
s = x**2 <= 16 reach ~100 and cancel to an O(1) value, so one fp32 rounding
more or less per term moves the result by up to ~100 * 2**-24 per step
(measured: <= 2e-5 beyond one bf16 ulp at |x| <= 8).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unispeech_tpu_torch.ops.kernels import vpu_micro
from unispeech_tpu_torch.scripts import exp_vpu_micro

REPO = pathlib.Path(__file__).resolve().parent.parent
SHAPE = (2, 1024, 128)
JAX_FNS = {  # the script's list in main(), by name
    "copy": lambda m: (lambda v: v),
    "exp": lambda m: (lambda v: jnp.exp(v.astype(jnp.float32))),
    "gelu_poly8": lambda m: m.gelu_poly,
    "gelu_poly6c": lambda m: m.gelu_p6,
    "gelu_AS_exp": lambda m: m.gelu_as,
    "dgelu_poly8": lambda m: m.dgelu_poly,
    "gelu+dgelu6": lambda m: m.gelu_dgelu_p6,
}
POLY = ("gelu_poly8", "gelu_poly6c", "dgelu_poly8", "gelu+dgelu6")


@pytest.fixture(scope="module")
def jax_script():
    """scripts/exp_vpu_micro.py loaded as a module, its grid cut to SHAPE."""
    spec = importlib.util.spec_from_file_location(
        "exp_vpu_micro_jax", REPO / "scripts" / "exp_vpu_micro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.T, mod.C = SHAPE
    return mod


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits); the smallest normal's ulp at 0."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_variants_match_the_script_order():
    assert list(vpu_micro.VARIANTS) == list(JAX_FNS)


@pytest.mark.parametrize("variant", list(JAX_FNS))
def test_matches_pallas_pass(jax_script, variant):
    x = (np.random.RandomState(7).randn(*SHAPE) * 2.0).astype(np.float32)
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jax_script.run(JAX_FNS[variant](jax_script), xj)
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    before = vpu_micro.launches
    got = vpu_micro.run(variant, xt)
    assert vpu_micro.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and got.shape == SHAPE
    got = got.float().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    tol = _bf16_ulp(want) + (2.0 ** -14 if variant in POLY else 0.0)
    assert (err <= tol).all(), float((err / tol).max())


def test_entry_point_cpu(capsys):
    exp_vpu_micro.main(["--device", "cpu", "--shape", "1,1024,128", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(vpu_micro.VARIANTS)
    for ln in lines:
        fields = ln.split()
        assert fields[2] == "ms" and float(fields[1]) > 0
        assert ln.endswith("plain version on the CPU")


def test_entry_point_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_vpu_micro.main(["--shape", "1,1024,128", "--iters", "1"])


def test_run_rejects_unknown_variant():
    with pytest.raises(ValueError):
        vpu_micro.run("tanh", torch.zeros(8, dtype=torch.bfloat16))


def test_bound_counts_four_bytes_per_element():
    n = 6 * 49152 * 512
    assert exp_vpu_micro.bound_ms(n) == pytest.approx(4 * n / 3.35e12 * 1e3)
    assert 0.179 < exp_vpu_micro.bound_ms(n) < 0.181
