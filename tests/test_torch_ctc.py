"""The port's CTC fine-tuning against the JAX package's (CPU): the loss, the
greedy collapse, the CtcFinetuneModel on a padded batch, the freeze gate,
the graft of a pretrained backbone and the train step, frozen and not.

Tiny models are initialised by JAX from a seed in fp32 and carried into the
port with ``ctc_state_dict_from_jax`` (``load_state_dict(strict=True)``).
Masks, dropout and layerdrop are off, so both sides compute the same
function.

Tolerances, fp32: the loss and its logit gradient rtol 1e-5 (one log-space
recursion in other orders); logits rtol 1e-5 / atol 1e-5, as the
pretraining model's (tests/test_torch_train.py); a train step's loss rtol
1e-5 and its gradient norm rtol 1e-4: the CTC gradient is a difference of
O(1) terms (softmax less the path posterior), taken by ``F.ctc_loss``'s
alpha-beta recursion here and by autodiff through optax's scan in JAX, so
every parameter's gradient differs by ~1e-5 relative (1.4e-5 for the head,
up to 7e-5 for the small rel-pos parameters), the per-parameter bound of
tests/test_torch_train.py; parameters after a frozen AdamW step atol 2e-6
at lr 1e-3 (the same reckoning as there). The first unfrozen step is the
encoder's first Adam step, which divides each gradient element by its own
size: an element whose gradient is within the fp32 noise of 0 (the CTC
gradient is 1.5e-5 (JAX) and 3e-5 (``F.ctc_loss``) off an fp64 one,
relative L2) moves by up to lr either way. So that step's gradients are
held per tensor at relative L2 1e-4 (+1e-6 of the global norm, as in
tests/test_torch_train.py), and the parameters after it atol 2e-6 where
the gradient element exceeds 1e-3 of its tensor's norm. Integer results
(greedy tokens, frame counts) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import EncoderConfig as JEncoderConfig
from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
from unispeech_tpu.models.ctc import CtcFinetuneConfig as JCtcConfig
from unispeech_tpu.models.ctc import CtcFinetuneModel as JCtcModel
from unispeech_tpu.models.ctc import load_pretrained_into as jax_graft
from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
from unispeech_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from unispeech_tpu.ops.ctc import greedy_decode as jax_greedy
from unispeech_tpu.train import optim as joptim
from unispeech_tpu.train.checkpoint import save_params_npz
from unispeech_tpu.train.state import create_train_state as jax_create_state
from unispeech_tpu.train.state import make_train_step as jax_make_step
from unispeech_tpu.train.tasks import make_ctc_finetune_loss_fn as jax_make_loss_fn
from unispeech_tpu_torch.configs import EncoderConfig, HubertPretrainConfig, MaskConfig
from unispeech_tpu_torch.convert.from_jax import (
    ctc_state_dict_from_jax,
    hubert_state_dict_from_jax,
    jax_params_from_ctc_state_dict,
    jax_params_of,
)
from unispeech_tpu_torch.models.ctc import (
    CtcFinetuneConfig,
    CtcFinetuneModel,
    load_pretrained_into,
)
from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.ops.ctc import ctc_loss, greedy_decode
from unispeech_tpu_torch.train import optim
from unispeech_tpu_torch.train.state import create_train_state, make_train_step
from unispeech_tpu_torch.train.tasks import make_ctc_finetune_loss_fn

ENC = dict(
    conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0,
    relative_position_embedding=True, num_buckets=32, max_distance=64, gru_rel_pos=True,
)
# WavLM-Large's structure: the layer_norm extractor, pre-LN, normalized input
LARGE_STYLE = dict(extractor_mode="layer_norm", layer_norm_first=True, normalize=True)
VOCAB = 12
B, NS = 3, 3000
LENGTHS = np.asarray([3000, 2400, 1700], np.int32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads (see test_torch_train)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(enc=None, **over):
    e = {**ENC, **(enc or {})}
    kw = {"vocab_size": VOCAB, "apply_mask": False, **over}
    jcfg = JCtcConfig(encoder=JEncoderConfig(**e), **kw)
    cfg = CtcFinetuneConfig(encoder=EncoderConfig(**e), **kw)
    jmodel = JCtcModel(jcfg)
    k = jax.random.PRNGKey(0)
    params = to_numpy(jmodel.init({"params": k, "mask": k, "dropout": k},
                                  jnp.zeros((1, NS)), deterministic=True)["params"])
    model = CtcFinetuneModel(cfg)
    model.load_state_dict(ctc_state_dict_from_jax(params, cfg.encoder), strict=True)
    return jmodel, params, cfg, model


def batch(seed=0, S=6):
    rng = np.random.RandomState(seed)
    return {"source": rng.randn(B, NS).astype(np.float32), "lengths": LENGTHS,
            "labels": rng.randint(4, VOCAB, (B, S)).astype(np.int32),
            "label_lengths": np.asarray([S, 4, 3], np.int32)}


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_ctc_loss_matches_jax_and_zeroes_infeasible_rows():
    """Rows 0-1 feasible, row 2 of length 0 (a padding row), row 3
    infeasible (6 labels in 4 frames). The feasible and zero-length rows
    match JAX's loss and logit gradient; on the infeasible row JAX keeps
    optax's finite floor (> 1e4) where the port gives 0."""
    rng = np.random.RandomState(3)
    T, V = 12, 8
    logits = rng.randn(4, T, V).astype(np.float32)
    logit_lengths = np.asarray([12, 9, 0, 4], np.int32)
    labels = np.full((4, 6), 1, np.int32)
    labels[0, :5] = [2, 3, 3, 4, 5]
    labels[1, :3] = [6, 2, 7]
    labels[3, :6] = [2, 3, 4, 5, 6, 7]
    label_lengths = np.asarray([5, 3, 0, 6], np.int32)
    args = (logits, logit_lengths, labels, label_lengths)

    def per_row(fn, conv, r):
        loss, ntok = fn(*(conv(a[r:r + 1]) for a in args))
        return float(loss), int(ntok)

    for r in range(3):
        want, jn = per_row(jax_ctc_loss, jnp.asarray, r)
        got, n = per_row(ctc_loss, torch.from_numpy, r)
        assert n == jn == label_lengths[r]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=str(r))
    assert per_row(ctc_loss, torch.from_numpy, 2)[0] == 0.0
    assert per_row(jax_ctc_loss, jnp.asarray, 3)[0] > 1e4
    assert per_row(ctc_loss, torch.from_numpy, 3)[0] == 0.0

    # the whole batch: the port's sum is JAX's less the infeasible row, and
    # the logit gradients of the other rows agree; the infeasible row's is 0
    jl = lambda x: jax_ctc_loss(x, *map(jnp.asarray, args[1:]))[0]
    jax_feasible = lambda x: jax_ctc_loss(x[:3], *(jnp.asarray(a[:3]) for a in args[1:]))[0]
    tl = torch.from_numpy(logits).requires_grad_()
    loss, ntok = ctc_loss(tl, *map(torch.from_numpy, args[1:]))
    loss.backward()
    assert int(ntok) == label_lengths.sum()
    np.testing.assert_allclose(float(loss.detach()), float(jax_feasible(jnp.asarray(logits))), rtol=1e-5)
    assert float(jl(jnp.asarray(logits))) > float(loss) + 1e4
    want_g = np.asarray(jax.grad(jax_feasible)(jnp.asarray(logits)))
    np.testing.assert_allclose(tl.grad[:3].numpy(), want_g[:3], rtol=1e-5, atol=1e-6)
    assert not tl.grad[2:].any()


def test_greedy_decode_matches_jax():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 5, (3, 16))
    ids[0, 3:6] = 2  # a repeat run
    ids[1, 4:8] = 0  # blanks between equal tokens
    ids[1, 3] = ids[1, 8] = 3
    logits = np.eye(5, dtype=np.float32)[ids] + rng.rand(3, 16, 5).astype(np.float32) * 0.1
    lengths = np.asarray([16, 11, 0], np.int32)
    jt, jn = jax_greedy(jnp.asarray(logits), jnp.asarray(lengths))
    tt, tn = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lengths))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("enc", [None, LARGE_STYLE], ids=["base", "large_style"])
def test_logits_and_frame_lengths_match_jax(enc):
    jmodel, params, cfg, model = build_pair(enc)
    b = batch()
    jout = jmodel.apply({"params": params}, jnp.asarray(b["source"]),
                        jnp.asarray(b["lengths"]), deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(b["source"]), torch.from_numpy(b["lengths"]))
    assert out.logits.dtype == torch.float32 and out.logits.shape == jout.logits.shape
    np.testing.assert_array_equal(out.frame_lengths.numpy(), np.asarray(jout.frame_lengths))
    assert len(set(out.frame_lengths.tolist())) == B  # the batch is padded
    np.testing.assert_array_equal(out.padding_mask.numpy(), np.asarray(jout.padding_mask))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), rtol=1e-5,
                               atol=1e-5)


def test_params_round_trip():
    _, params, cfg, model = build_pair()
    back = jax_params_from_ctc_state_dict(model.state_dict(), cfg.encoder)
    assert jax_params_of(model).keys() == back.keys() == {"wavlm", "proj"}
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_freeze_gate():
    """Before ``freeze_finetune_updates`` the backbone's gradients are
    exactly 0 (none at all: it ran without autograd) and the head's are
    not; from that step on the encoder's are nonzero. The conv frontend
    gets no gradient at any step (``feature_grad_mult = 0``)."""
    _, _, _, model = build_pair(freeze_finetune_updates=3)
    loss_fn = make_ctc_finetune_loss_fn(model, deterministic=True)
    tb = torch_batch(batch(1))
    grads = {}
    for step in (2, 3):
        model.zero_grad(set_to_none=True)
        loss, _, _ = loss_fn(tb, None, step)
        loss.backward()
        grads[step] = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is None for n, g in grads[2].items() if n.startswith("wavlm."))
    assert grads[2]["proj.weight"].abs().max() > 0
    live = grads[3]
    assert all(live[n] is None for n in live if n.startswith("wavlm.feature_extractor."))
    assert all(live[n] is not None and live[n].abs().max() > 0 for n in live
               if n.startswith("wavlm.encoder.layers.") and "k_proj.bias" not in n)


@pytest.mark.parametrize("source", ["state_dict", "npz"])
def test_graft_from_pretraining_model(tmp_path, source):
    """A HubertPretrainModel's backbone grafted into a fine-tune model, from
    its state dict or from its JAX-layout params ``.npz``, gives the JAX
    package's graft; the head keeps its init and the pretraining heads
    are dropped."""
    jmodel, params, cfg, model = build_pair()
    hcfg = dict(num_classes=(13,), final_dim=16)
    jh = JHubert(JHubertConfig(encoder=JEncoderConfig(**ENC), **hcfg))
    k = jax.random.PRNGKey(7)
    T = EncoderConfig(**ENC).num_frames(NS)
    hparams = to_numpy(jh.init({"params": k, "mask": k}, jnp.zeros((1, NS)),
                               jnp.zeros((1, T, 1), jnp.int32), mask=True)["params"])
    want = ctc_state_dict_from_jax(to_numpy(jax_graft(params, hparams)), cfg.encoder)
    if source == "npz":
        path = str(tmp_path / "pretrained.npz")
        save_params_npz(path, hparams)
        load_pretrained_into(model, path)
    else:
        hub_cfg = HubertPretrainConfig(encoder=EncoderConfig(**ENC), **hcfg)
        hub = HubertPretrainModel(hub_cfg)
        hub.load_state_dict(hubert_state_dict_from_jax(hparams, hub_cfg), strict=True)
        load_pretrained_into(model, hub.state_dict())
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name].numpy(), v.numpy(), err_msg=name)
    np.testing.assert_array_equal(got["proj.weight"].numpy(), params["proj"]["kernel"].T)


def test_frozen_and_unfrozen_steps_match_jax():
    """Two steps of the port's make_train_step against JAX's, at a fixed lr:
    step 0 is frozen (the backbone moves by AdamW's decoupled weight decay
    alone, the head by the Adam update), step 1 is not."""
    jmodel, params, cfg, model = build_pair(freeze_finetune_updates=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = dict(lr=1e-3, schedule="fixed")
    tx = joptim.make_optimizer(joptim.OptimConfig(**opt))
    jstate = jax_create_state(params, tx)
    jstep = jax_make_step(jax_make_loss_fn(jmodel), tx, donate_state=False)
    state = create_train_state(model, optim.OptimConfig(**opt), device="cpu")
    step = make_train_step(make_ctc_finetune_loss_fn(model))
    b = batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss = jax_make_loss_fn(jmodel)
    for i in range(2):
        if i == 1:  # JAX's gradient of the unfrozen step, divided by the sample size
            grads = jax.grad(lambda p: (lambda l, ss, _: l / ss)(
                *jloss(p, jb, jax.random.PRNGKey(0), 1)))(jstate.params)
            jgrad = ctc_state_dict_from_jax(to_numpy(grads), cfg.encoder)
            total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrad.values()))
        jstate, jmet = jstep(jstate, jb, jax.random.PRNGKey(0))
        met = step(state, torch_batch(b), torch.Generator().manual_seed(0))
        for k, rtol in (("loss_per_sample", 1e-5), ("grad_norm", 1e-4), ("sample_size", 0)):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol, err_msg=k)
        want = ctc_state_dict_from_jax(to_numpy(jstate.params), cfg.encoder)
        for name, p in model.named_parameters():
            got, w = p.detach().numpy(), want[name].numpy()
            if i == 0:
                np.testing.assert_allclose(got, w, atol=2e-6, rtol=0, err_msg=name)
                continue
            g, wg = p.grad.numpy(), jgrad[name].numpy()
            assert np.linalg.norm(g - wg) <= 1e-4 * np.linalg.norm(wg) + 1e-6 * total, name
            sure = np.abs(wg) > 1e-3 * np.linalg.norm(wg)
            np.testing.assert_allclose(got[sure], w[sure], atol=2e-6, rtol=0, err_msg=name)
        if i == 0:
            fc1 = "wavlm.encoder.layers.1.fc1.weight"
            np.testing.assert_allclose(model.state_dict()[fc1].numpy(),
                                       (before[fc1] * (1 - 1e-3 * 0.01)).numpy(), rtol=1e-6)
    fe = "wavlm.feature_extractor.conv_layers.1.0.weight"
    np.testing.assert_allclose(model.state_dict()[fe].numpy(),
                               (before[fe] * (1 - 1e-3 * 0.01) ** 2).numpy(), rtol=1e-6)


def test_masked_training_step_is_finite_and_reproducible():
    """Fine-tuning's masks (time 0.65/10, channel 0.5/64 with the channel
    span cut to 16 of the tiny model's 64) and final dropout draw from the
    generator: the same seed gives the same step, another seed another
    loss."""
    cfg = CtcFinetuneConfig(encoder=EncoderConfig(**ENC), vocab_size=VOCAB, final_dropout=0.1,
                            channel_mask=MaskConfig(mask_prob=0.5, mask_length=16, min_masks=0))
    losses = []
    for seed in (0, 0, 1):
        model = CtcFinetuneModel(cfg, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, optim.OptimConfig(lr=1e-3, schedule="fixed"),
                                   device="cpu")
        step = make_train_step(make_ctc_finetune_loss_fn(model))
        met = step(state, torch_batch(batch(3)), torch.Generator().manual_seed(seed))
        losses.append((float(met["loss_per_sample"]), float(met["grad_norm"])))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert np.isfinite(losses).all()
