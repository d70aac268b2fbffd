"""The port's masked-prediction pretraining against the JAX package's (CPU).

A tiny HubertPretrainModel (WavLM backbone with the gated relative position
bias) is initialised by JAX from a seed in fp32, its params carried into
the port with ``hubert_state_dict_from_jax`` and loaded with
``strict=True``. Dropout and layerdrop are 0 and the port is fed the masks
JAX's forward drew, so both sides compute the same function; the JAX side
runs its unfused CPU path, the port its fused structure with the plain
versions of its ops, so this also holds the fused backward algebra to JAX's
autodiff.

Tolerances, fp32: logits and loss rtol 1e-5 (one forward, sums in other
orders); per-parameter gradients relative L2 1e-4 (a backward through two
layers sums ~1e3-term products in other orders), plus 1e-6 of the global
gradient norm for gradients that are zero analytically (the k_proj bias:
softmax ignores a per-query constant) and float noise on both sides;
parameters after 3 AdamW
steps atol 2e-6 at lr 1e-3 (each step moves a parameter by about lr;
gradient noise of 1e-4 relative moves the update by 1e-4 of that, and
eps = 1e-6 bounds the normalised step of a near-zero gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unispeech_tpu.configs import EncoderConfig as JEncoderConfig
from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
from unispeech_tpu.configs import MaskConfig as JMaskConfig
from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
from unispeech_tpu.train import optim as joptim
from unispeech_tpu.train.losses import HubertCriterionConfig as JCrit
from unispeech_tpu.train.losses import hubert_loss as jax_hubert_loss
from unispeech_tpu.train.state import create_train_state as jax_create_state
from unispeech_tpu.train.state import make_train_step as jax_make_step
from unispeech_tpu.train.tasks import make_hubert_loss_fn as jax_make_loss_fn
from unispeech_tpu.train.tasks import split_rngs
from unispeech_tpu_torch.configs import EncoderConfig, HubertPretrainConfig, MaskConfig
from unispeech_tpu_torch.convert.from_jax import (
    hubert_state_dict_from_jax,
    jax_params_from_hubert_state_dict,
)
from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.train import optim
from unispeech_tpu_torch.train.losses import HubertCriterionConfig, hubert_loss
from unispeech_tpu_torch.train.state import create_train_state, make_train_step
from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

ENC = dict(
    conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0,
    relative_position_embedding=True, num_buckets=32, max_distance=64, gru_rel_pos=True,
    remat_ffn=True,
)
HUB = dict(num_classes=(13,), final_dim=16)
# WavLM-Large's structure: the layer_norm extractor, pre-LN, normalized input
LARGE_STYLE = dict(extractor_mode="layer_norm", layer_norm_first=True, normalize=True)
B, NS = 3, 3000
LENGTHS = np.asarray([3000, 2400, 1700], np.int32)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under a
    parallel test run (several worker processes on few cores) OpenMP's
    spinning threads slow them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(enc=None, **hub):
    e = {**ENC, **(enc or {})}
    h = {**HUB, **hub}
    mask = dict(mask_prob=0.65, mask_length=4)
    jcfg = JHubertConfig(encoder=JEncoderConfig(**e), time_mask=JMaskConfig(**mask), **h)
    cfg = HubertPretrainConfig(encoder=EncoderConfig(**e), time_mask=MaskConfig(**mask), **h)
    return jcfg, cfg


def to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(enc=None, **hub):
    jcfg, cfg = configs(enc, **hub)
    jmodel = JHubert(jcfg)
    T = jcfg.encoder.num_frames(NS)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                         jnp.zeros((1, NS)), jnp.zeros((1, T, 1), jnp.int32),
                         mask=True, deterministic=True)["params"]
    params = to_numpy(params)
    model = HubertPretrainModel(cfg)
    model.load_state_dict(hubert_state_dict_from_jax(params, cfg), strict=True)
    return jcfg, jmodel, params, cfg, model


def batch(seed=0, num_classes=(13,)):
    rng = np.random.RandomState(seed)
    T = EncoderConfig(**ENC).num_frames(NS)
    targets = np.stack([rng.randint(0, c, (B, T)) for c in num_classes], -1)
    return {"source": rng.randn(B, NS).astype(np.float32),
            "targets": targets.astype(np.int32), "lengths": LENGTHS}


def jax_mask(jmodel, params, b, rng):
    out = jax.jit(lambda p, r: jmodel.apply(
        {"params": p}, jnp.asarray(b["source"]), jnp.asarray(b["targets"]),
        jnp.asarray(b["lengths"]), mask=True, deterministic=False, rngs=split_rngs(r),
        features_only=True).mask_indices)(params, rng)
    return np.array(out)


def torch_batch(b, mask=None):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    if mask is not None:
        tb["boundary_mask"] = torch.from_numpy(mask)
    return tb


@pytest.mark.parametrize("enc,variant", [
    (None, dict()),
    (None, dict(predict_layers=(1, 2), separate_label_embeds=True, target_glu=True)),
    (None, dict(num_classes=(13, 7), untie_final_proj=True)),
    (LARGE_STYLE, dict()),
], ids=["base", "ils_glu", "two_sets_untied", "large_style"])
def test_forward_loss_and_gradients_match_jax(enc, variant):
    jcfg, jmodel, params, cfg, model = build_pair(enc, **variant)
    b = batch(num_classes=cfg.num_classes)
    rngs = split_rngs(jax.random.PRNGKey(5))
    jcrit = JCrit()

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(b["source"]), jnp.asarray(b["targets"]),
                           jnp.asarray(b["lengths"]), mask=True, deterministic=False, rngs=rngs)
        loss, ss, met = jax_hubert_loss(out, jcrit)
        return loss, (out, met)

    (jl, (jout, jmet)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    mask = np.asarray(jout.mask_indices)
    out = model(*(torch_batch(b)[k] for k in ("source", "targets", "lengths")), mask=True,
                deterministic=False, generator=torch.Generator(),
                boundary_mask=torch.from_numpy(mask.copy()))
    loss, ss, met = hubert_loss(out, HubertCriterionConfig())
    np.testing.assert_array_equal(out.mask_indices.numpy(), mask)
    assert sorted(out.logits) == sorted(jout.logits)
    for key in jout.logits:
        np.testing.assert_allclose(out.logits[key].detach().numpy(), np.asarray(jout.logits[key]),
                                   rtol=1e-5, atol=1e-5)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(met[k].detach()), float(v), rtol=1e-5, err_msg=k)
    loss.backward()
    want = hubert_state_dict_from_jax(to_numpy(jgrads), cfg)
    total = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-6 * total, name


@pytest.mark.parametrize("enc", [None, LARGE_STYLE], ids=["base", "large_style"])
def test_train_steps_match_jax(enc):
    """3 steps of the port's make_train_step against JAX's (warmup: step 0
    has lr 0, so steps 1 and 2 move the parameters)."""
    jcfg, jmodel, params, cfg, model = build_pair(enc)
    b = batch(seed=1)
    rng = jax.random.PRNGKey(7)
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT))
    jstate = jax_create_state(params, tx)
    jstep = jax_make_step(jax_make_loss_fn(jmodel, JCrit()), tx, donate_state=False)
    state = create_train_state(model, optim.OptimConfig(**OPT), device="cpu")
    step = make_train_step(make_hubert_loss_fn(model, HubertCriterionConfig()))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    for i in range(3):
        mask = jax_mask(jmodel, jstate.params, b, jax.random.fold_in(rng, i))
        jstate, jmet = jstep(jstate, jb, rng)
        met = step(state, torch_batch(b, mask), torch.Generator())
        for k in ("loss_per_sample", "grad_norm", "sample_size"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = hubert_state_dict_from_jax(to_numpy(jstate.params), cfg)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-6,
                                   rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(want[name].numpy() - hubert_state_dict_from_jax(
            params, cfg)[name].numpy()).max()))
    assert moved > 1e-4  # the parameters did move


@pytest.mark.parametrize("enc", [None, LARGE_STYLE], ids=["base", "large_style"])
def test_zero_length_padded_rows_change_nothing(enc):
    """Two zero rows of length 0 (the data pipeline's fixed-shape padding)
    with a fixed boundary_mask: the same loss, sample size and gradients as
    the batch without them (fp32, rtol 1e-5; gradients relative L2 1e-5, the
    same sums batched in other GEMM shapes, plus 1e-6 of the global norm for
    the gradients that are zero analytically, as above)."""
    _, _, _, cfg, model = build_pair(enc)
    b = batch(seed=6)
    T = cfg.encoder.num_frames(NS)
    mask = np.random.RandomState(0).rand(B + 2, T) < 0.5
    padded = {k: np.concatenate([v, np.zeros((2,) + v.shape[1:], v.dtype)])
              for k, v in b.items()}
    results = []
    for bb, m in ((b, mask[:B]), (padded, mask)):
        model.zero_grad(set_to_none=True)
        out = model(*(torch_batch(bb)[k] for k in ("source", "targets", "lengths")), mask=True,
                    deterministic=False, generator=torch.Generator(),
                    boundary_mask=torch.from_numpy(m.copy()))
        loss, ss, _ = hubert_loss(out, HubertCriterionConfig())
        loss.backward()
        assert torch.isfinite(loss)
        results.append((float(loss.detach()), float(ss),
                        {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l0, s0, g0), (l1, s1, g1) = results
    assert s0 == s1 > 0
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g0.values())))
    for name, g in g0.items():
        assert torch.isfinite(g1[name]).all(), name
        assert float((g1[name] - g).norm()) <= 1e-5 * float(g.norm()) + 1e-6 * total, name


def test_accum_steps_equal_one_step_on_the_concatenated_batch():
    """Without the feature penalty (a per-microbatch mean scaled by its
    sample size, so not additive over microbatches, on either side)."""
    crit = HubertCriterionConfig(features_pen_weight=0.0)
    _, _, params, cfg, model = build_pair()
    b1, b2 = batch(seed=2), batch(seed=3)
    g = torch.Generator().manual_seed(0)
    masks = [torch.rand(B, EncoderConfig(**ENC).num_frames(NS), generator=g) < 0.5
             for _ in range(2)]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    accum = make_train_step(make_hubert_loss_fn(model, crit), accum_steps=2)
    state = create_train_state(model, optim.OptimConfig(**OPT, schedule="fixed"), device="cpu")
    tb = [torch_batch(x, m.numpy()) for x, m in zip((b1, b2), masks)]
    stacked = {k: torch.stack([tb[0][k], tb[1][k]]) for k in tb[0]}
    met_a = accum(state, stacked, torch.Generator())
    after_accum = {k: v.clone() for k, v in model.state_dict().items()}

    model.load_state_dict(sd)
    state = create_train_state(model, optim.OptimConfig(**OPT, schedule="fixed"), device="cpu")
    one = make_train_step(make_hubert_loss_fn(model, crit))
    cat = {k: torch.cat([tb[0][k], tb[1][k]]) for k in tb[0]}
    met_c = one(state, cat, torch.Generator())
    for k in ("loss_per_sample", "grad_norm", "sample_size"):
        np.testing.assert_allclose(float(met_a[k]), float(met_c[k]), rtol=1e-5, err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after_accum[k].numpy(), atol=1e-6, err_msg=k)


def test_inner_steps_stack_metrics():
    _, _, _, cfg, model = build_pair()
    tb = [torch_batch(batch(seed=s)) for s in (4, 5)]
    stacked = {k: torch.stack([tb[0][k], tb[1][k]]) for k in tb[0]}
    state = create_train_state(model, optim.OptimConfig(**OPT), device="cpu")
    step = make_train_step(make_hubert_loss_fn(model, HubertCriterionConfig()), inner_steps=2)
    met = step(state, stacked, torch.Generator().manual_seed(0))
    assert met["grad_norm"].shape == (2,) and state.step == 2
    assert torch.isfinite(met["loss_per_sample"]).all()


@pytest.mark.parametrize("sched", [
    dict(schedule="polynomial_decay", warmup_steps=3, total_steps=10, end_learning_rate=1e-5,
         power=2.0),
    dict(schedule="tri_stage", warmup_steps=2, hold_steps=2, decay_steps=4, total_steps=10),
    dict(schedule="inverse_sqrt", warmup_steps=3, warmup_init_lr=1e-5),
    dict(schedule="fixed"),
])
def test_schedules_match_optax(sched):
    jf = joptim.make_schedule(joptim.OptimConfig(**sched))
    f = optim.make_schedule(optim.OptimConfig(**sched))
    for s in range(14):
        np.testing.assert_allclose(f(s), float(jf(s)), rtol=1e-6, atol=1e-12, err_msg=str(s))


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_adamw_matches_optax(clip):
    """Several updates of random parameters by random gradients (one near
    zero): torch.optim.AdamW with the schedule and clip against optax."""
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip)
    tx = joptim.make_optimizer(joptim.OptimConfig(**cfg))
    jp = [jnp.asarray(p) for p in params]
    jst = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.make_optimizer(optim.OptimConfig(**cfg), tp)
    for step in range(5):
        grads = [rng.randn(*s).astype(np.float32) * (1e-9 if i == 1 else 1.0)
                 for i, s in enumerate(shapes)]
        upd, jst = tx.update([jnp.asarray(g) for g in grads], jst, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step(torch.nn.utils.get_total_norm([p.grad for p in tp]))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_hubert_params_round_trip():
    """The inverse carry gives back the JAX tree (ILS tables included)."""
    _, _, params, cfg, model = build_pair(predict_layers=(1, 2), separate_label_embeds=True,
                                          target_glu=True)
    back = jax_params_from_hubert_state_dict(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_layerdrop_gives_zero_gradients_and_counts():
    """A layer layerdrop skips runs no kernel and its parameters get zero
    gradients (not None), so AdamW still decays them as optax does."""
    _, cfg = configs(enc=dict(encoder_layerdrop=0.99))
    model = HubertPretrainModel(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, optim.OptimConfig(**OPT, schedule="fixed"), device="cpu")
    step = make_train_step(make_hubert_loss_fn(model, HubertCriterionConfig()))
    before = model.encoder.layers[1].fc1.weight.detach().clone()
    met = step(state, torch_batch(batch()), torch.Generator().manual_seed(3))
    assert met["layers_dropped"] == 2
    layer = model.encoder.layers[1]
    assert layer.fc1.weight.grad is not None and not layer.fc1.weight.grad.any()
    # weight decay alone moved it: p * (1 - lr * wd)
    np.testing.assert_allclose(layer.fc1.weight.detach().numpy(),
                               (before * (1 - 1e-3 * 0.01)).numpy(), rtol=1e-6)


def test_dropout_training_is_reproducible_and_random():
    """With dropout and layerdrop on, the same generator seed gives the same
    step; another seed gives another loss."""
    _, cfg = configs(enc=dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                              encoder_layerdrop=0.05, remat_layers=True, remat_ffn=False))
    losses = []
    for seed in (0, 0, 1):
        model = HubertPretrainModel(cfg, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, optim.OptimConfig(**OPT), device="cpu")
        step = make_train_step(make_hubert_loss_fn(model, HubertCriterionConfig()))
        met = step(state, torch_batch(batch()), torch.Generator().manual_seed(seed))
        losses.append((float(met["loss_per_sample"]), float(met["grad_norm"])))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert all(np.isfinite(losses).ravel())


def test_not_ported_raise(tmp_path):
    """What is still not ported raises: sharding, pretrain-hubert's
    --n-model > 1, --fsdp and multi-host flags. The GLU feed-forward and
    training with iPQ noise (quant_noise_pq) now run: a train step of each
    is finite and moves the parameters."""
    import dataclasses as dc

    from unispeech_tpu_torch.train import __main__ as train_cli
    from unispeech_tpu_torch.train.state import shard_train_state

    _, cfg = configs()
    for over in (dict(activation_fn="glu"), dict(quant_noise_pq=0.1)):
        model = HubertPretrainModel(dc.replace(cfg, encoder=dc.replace(cfg.encoder, **over)),
                                    generator=torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state = create_train_state(model, optim.OptimConfig(lr=1e-3, schedule="fixed"),
                                   device="cpu")
        step = make_train_step(make_hubert_loss_fn(model, HubertCriterionConfig()))
        met = step(state, torch_batch(batch()), torch.Generator().manual_seed(0))
        assert np.isfinite(float(met["loss_per_sample"])), over
        assert np.isfinite(float(met["grad_norm"])) and float(met["grad_norm"]) > 0, over
        moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
        assert "encoder.layers.0.fc2.weight" in moved, over
    with pytest.raises(NotImplementedError):
        shard_train_state(None)
    (tmp_path / "m.tsv").write_text(f"{tmp_path}\n")
    (tmp_path / "l.km").write_text("")
    base = ["pretrain-hubert", "--manifest", str(tmp_path / "m.tsv"), "--labels",
            str(tmp_path / "l.km"), "--device", "cpu"]
    for extra in (["--n-model", "2"], ["--fsdp"],
                  ["--coordinator-address", "localhost:1234"]):
        with pytest.raises(NotImplementedError):
            train_cli.main(base + extra)
