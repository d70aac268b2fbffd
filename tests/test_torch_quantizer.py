"""The port's vector quantizers against the JAX package's (CPU, fp32).

The JAX draws cannot be replayed from torch's RNG, so each test records
them: ``JaxDraws`` wraps ``jax.random.<name>`` (through pytest's
monkeypatch) with a function that calls the real one and keeps its output,
and the recorded draws are fed to the port's sampling functions, also
through monkeypatch. Nothing in the JAX package changes for this.

Tolerances, fp32: forwards, perplexities and losses rtol 1e-5 (one
forward, sums in other orders); gradients relative L2 1e-5; ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import GumbelVQConfig as JGumbelVQConfig
from unispeech_tpu.ops.quantizer import GumbelVectorQuantizer as JGumbel
from unispeech_tpu.ops.quantizer import KmeansVectorQuantizer as JKmeans
from unispeech_tpu_torch.configs import GumbelVQConfig
from unispeech_tpu_torch.ops import quantizer
from unispeech_tpu_torch.ops.quantizer import GumbelVectorQuantizer, KmeansVectorQuantizer


class JaxDraws:
    """Records the outputs of ``jax.random.<name>`` for each name given:
    ``self.calls[name]`` lists them in call order (jit or not)."""

    def __init__(self, monkeypatch, *names):
        self.calls = {n: [] for n in names}
        for n in names:
            real = getattr(jax.random, n)

            def wrap(*a, _real=real, _n=n, **k):
                out = _real(*a, **k)
                jax.debug.callback(lambda v, _n=_n: self.calls[_n].append(np.array(v)), out)
                return out

            monkeypatch.setattr(jax.random, n, wrap)

    def one(self, name, shape):
        """The single recorded draw of ``name`` with ``shape``."""
        got = [v for v in self.calls[name] if v.shape == tuple(shape)]
        assert len(got) == 1, (name, shape, [v.shape for v in self.calls[name]])
        return got[0]


def feed(monkeypatch, module, name, *values):
    """Make ``module.name`` return ``values`` in order, as torch tensors (a
    tuple of arrays as a tuple of tensors)."""
    def tensor(v):
        return tuple(map(tensor, v)) if isinstance(v, tuple) else torch.from_numpy(np.array(v))

    queue = [tensor(v) for v in values]

    def fn(*args, **kwargs):
        return queue.pop(0)

    monkeypatch.setattr(module, name, fn)
    return queue


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def quantizer_sd(p, depth):
    """The port's state dict of a JAX GumbelVectorQuantizer's params."""
    sd = {"vars": p["vars"]}
    if depth == 1:
        sd.update({"weight_proj.weight": p["weight_proj"]["kernel"].T,
                   "weight_proj.bias": p["weight_proj"]["bias"]})
    else:
        for i in range(depth - 1):
            sd[f"weight_proj.{2 * i}.weight"] = p[f"weight_proj_{i}"]["kernel"].T
            sd[f"weight_proj.{2 * i}.bias"] = p[f"weight_proj_{i}"]["bias"]
        sd[f"weight_proj.{2 * (depth - 1)}.weight"] = p["weight_proj_out"]["kernel"].T
        sd[f"weight_proj.{2 * (depth - 1)}.bias"] = p["weight_proj_out"]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def build_gumbel(depth=1, input_dim=10):
    kw = dict(num_vars=6, groups=2, vq_dim=8, weight_proj_depth=depth, weight_proj_factor=2)
    jvq = JGumbel(JGumbelVQConfig(**kw), input_dim=input_dim)
    x = np.random.default_rng(3).standard_normal((2, 5, input_dim)).astype(np.float32)
    params = jax.tree.map(np.asarray, jvq.init({"params": jax.random.PRNGKey(3)},
                                               jnp.asarray(x), deterministic=True)["params"])
    vq = GumbelVectorQuantizer(GumbelVQConfig(**kw), input_dim)
    vq.load_state_dict(quantizer_sd(params, depth), strict=True)
    return jvq, params, vq, x


@pytest.mark.parametrize("depth", [1, 2])
def test_gumbel_hard_path_matches_jax(depth):
    jvq, params, vq, x = build_gumbel(depth)
    jres = jvq.apply({"params": params}, jnp.asarray(x), deterministic=True,
                     produce_targets=True)
    res = vq(torch.from_numpy(x), deterministic=True, produce_targets=True)
    np.testing.assert_array_equal(res["targets"].numpy(), np.asarray(jres["targets"]))
    np.testing.assert_allclose(res["x"].detach().numpy(), np.asarray(jres["x"]), rtol=1e-5,
                               atol=1e-6)
    for k in ("code_perplexity", "prob_perplexity", "temp"):
        np.testing.assert_allclose(float(torch.as_tensor(res[k]).detach()), float(jres[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(res["codebook"].detach().numpy(), np.asarray(jres["codebook"]))
    assert res["num_vars"] == jres["num_vars"] == 12


@pytest.mark.parametrize("depth,step", [(1, 0), (1, 40_000), (2, 7)])
def test_gumbel_straight_through_matches_jax(monkeypatch, depth, step):
    """The training path with JAX's recorded Gumbel noise: the forward,
    targets, perplexities and temperature, and the gradients with respect
    to x, weight_proj and vars (through the straight-through one-hot)."""
    jvq, params, vq, x = build_gumbel(depth)
    draws = JaxDraws(monkeypatch, "gumbel")
    cot = np.random.default_rng(4).standard_normal((2, 5, 8)).astype(np.float32)

    def jloss(p, xx):
        r = jvq.apply({"params": p}, xx, num_updates=step, deterministic=False,
                      produce_targets=True, rngs={"gumbel": jax.random.PRNGKey(9)})
        return jnp.sum(r["x"] * cot) + r["prob_perplexity"], r

    (jl, jres), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    noise = draws.one("gumbel", (2 * 5 * 2, 6))
    feed(monkeypatch, quantizer, "gumbel_noise", noise)
    xt = torch.from_numpy(x).requires_grad_()
    res = vq(xt, num_updates=step, deterministic=False, produce_targets=True,
             generator=torch.Generator())
    loss = (res["x"] * torch.from_numpy(cot)).sum() + res["prob_perplexity"]
    loss.backward()
    np.testing.assert_allclose(res["x"].detach().numpy(), np.asarray(jres["x"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(res["targets"].numpy(), np.asarray(jres["targets"]))
    for k in ("code_perplexity", "prob_perplexity", "temp"):
        np.testing.assert_allclose(float(torch.as_tensor(res[k]).detach()), float(jres[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = quantizer_sd(jax.tree.map(np.asarray, jg), depth)
    for name, p in vq.named_parameters():
        assert rel_l2(p.grad.numpy(), want[name].numpy()) <= 1e-5, name
    assert rel_l2(xt.grad.numpy(), np.asarray(jgx)) <= 1e-5


def test_padding_mask_keeps_padded_frames_out_of_the_perplexities():
    """With a padding mask the perplexities are those of the valid frames
    alone: the JAX quantizer run on just those frames gives them (rtol
    1e-5). The diversity term's gradient reaches no padded frame (the JAX
    package averages over every frame of a padded batch)."""
    jvq, params, vq, _ = build_gumbel()
    x = np.random.default_rng(5).standard_normal((3, 7, 10)).astype(np.float32)
    pad = np.arange(7)[None, :] >= np.asarray([7, 4, 0])[:, None]
    jres = jvq.apply({"params": params}, jnp.asarray(x[~pad][None]), deterministic=True)
    xt = torch.from_numpy(x).requires_grad_()
    res = vq(xt, deterministic=True, padding_mask=torch.from_numpy(pad))
    for k in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(res[k].detach()), float(jres[k]), rtol=1e-5, err_msg=k)
    res["prob_perplexity"].backward()
    g = xt.grad.numpy()
    assert not g[pad].any() and g[~pad].any()


def test_gumbel_noise_is_standard_gumbel_and_seeded():
    g = torch.Generator().manual_seed(0)
    n = quantizer.gumbel_noise((200_000,), g)
    # the standard Gumbel's mean is the Euler-Mascheroni constant, variance pi^2/6
    assert abs(float(n.mean()) - 0.5772) < 0.01 and abs(float(n.var()) - 1.6449) < 0.03
    a = quantizer.gumbel_noise((5,), torch.Generator().manual_seed(1))
    b = quantizer.gumbel_noise((5,), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(n).all()


def test_temp_at_takes_a_tensor_step():
    """A tensor step in fp32 as JAX's traced step, an int step in double
    precision as JAX's Python int (they part by 2.7e-4 at 40,000 updates:
    0.999995 rounded to fp32, raised to that power). The fp32 path within
    rtol 1e-4 of XLA's: two fp32 pow implementations, 2.3e-5 apart at
    40,000 updates; the double path rtol 1e-6."""
    cfg, jcfg = GumbelVQConfig(), JGumbelVQConfig()
    for s in (0, 1, 1000, 40_000, 400_000):
        t = cfg.temp_at(torch.tensor(s))
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(jcfg.temp_at(jnp.int32(s))), rtol=1e-4)
        np.testing.assert_allclose(cfg.temp_at(s), float(jcfg.temp_at(s)), rtol=1e-6)


@pytest.mark.parametrize("combine_groups", [False, True], ids=["grouped", "combined"])
def test_kmeans_vq_forward_and_gradients_match_jax(combine_groups):
    B, T, C, G, V = 2, 13, 16, 4, 11
    x = np.random.default_rng(0).standard_normal((B, T, C)).astype(np.float32)
    jvq = JKmeans(dim=C, num_vars=V, groups=G, combine_groups=combine_groups, vq_dim=C)
    params = jax.tree.map(np.asarray, jvq.init({"params": jax.random.PRNGKey(0)},
                                               jnp.asarray(x))["params"])
    vq = KmeansVectorQuantizer(C, V, G, combine_groups, C)
    vq.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                       strict=True)
    cot = np.random.default_rng(1).standard_normal((B, T, C)).astype(np.float32)

    def jloss(p, xx):
        r = jvq.apply({"params": p}, xx, produce_targets=True)
        return jnp.sum(r["x"] * cot) + r["kmeans_loss"], r

    (jl, jres), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    res = vq(xt, produce_targets=True)
    loss = (res["x"] * torch.from_numpy(cot)).sum() + res["kmeans_loss"]
    loss.backward()
    np.testing.assert_array_equal(res["targets"].numpy(), np.asarray(jres["targets"]))
    np.testing.assert_allclose(res["x"].detach().numpy(), np.asarray(jres["x"]), rtol=1e-5,
                               atol=1e-5)
    for k in ("code_perplexity", "kmeans_loss"):
        np.testing.assert_allclose(float(torch.as_tensor(res[k]).detach()), float(jres[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for name, p in vq.named_parameters():
        assert rel_l2(p.grad.numpy(), np.asarray(jg[name])) <= 1e-5, name
    assert rel_l2(xt.grad.numpy(), np.asarray(jgx)) <= 1e-5
    assert np.abs(xt.grad.numpy()).sum() > 0  # straight-through reaches the input
