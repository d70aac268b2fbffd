"""CTC fine-tuning at XLS-R 2B's head width (head dim 120) in the port
against the JAX package, on the CPU: the model at a narrow width, its train
step, and the converters at XLS-R 2B's full width.

XLS-R 2B (Babu et al., arXiv:2111.09296, Table 1) is the pre-LN,
layer_norm-extractor encoder at 48 layers, width 1920, FFN 7680 and 16 heads
of 120, the widest head of the wav2vec 2.0 line; ``chip_smoke.py``'s
``fp32_xlsr2b`` runs it on the card at 12 layers through the fp32 attention
forward's width-128 form. The narrow model keeps the head dim and the
structure: width 240 in 2 heads of 120, FFN 480, 2 layers, the positional
conv in 2 groups of 120 channels, tests/test_torch_xlarge.py's conv stack.
On the CPU the attention runs its plain version; JAX takes hd 120 head-major
(its packed layout needs 128 % hd == 0).

Tolerances as tests/test_torch_xlarge.py states them: logits rtol/atol
1e-5; loss rtol 1e-5, gradient norm rtol 1e-4, each tensor's gradient
relative L2 1e-4 + 1e-6 of the global norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_xlarge import NO_DROPOUT, VOCAB, XL_NARROW, _over, batch, to_numpy
from unispeech_tpu.configs import large_encoder_config as jax_large
from unispeech_tpu.models.ctc import CtcFinetuneConfig as JCtcConfig
from unispeech_tpu.models.ctc import CtcFinetuneModel as JCtcModel
from unispeech_tpu.train import optim as joptim
from unispeech_tpu.train.state import create_train_state as jax_create_state
from unispeech_tpu.train.state import make_train_step as jax_make_step
from unispeech_tpu.train.tasks import make_ctc_finetune_loss_fn as jax_make_loss_fn
from unispeech_tpu_torch.configs import large_encoder_config
from unispeech_tpu_torch.convert.from_jax import (
    ctc_state_dict_from_jax,
    jax_params_from_ctc_state_dict,
)
from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel
from unispeech_tpu_torch.train import optim
from unispeech_tpu_torch.train.state import create_train_state, make_train_step
from unispeech_tpu_torch.train.tasks import make_ctc_finetune_loss_fn

# the --encoder-json of XLS-R 2B, and of its narrow stand-in
XLSR2B = dict(encoder_layers=48, encoder_embed_dim=1920, encoder_ffn_embed_dim=7680,
              encoder_attention_heads=16, relative_position_embedding=False,
              gru_rel_pos=False)
WIDE_NARROW = dict(XL_NARROW, encoder_embed_dim=240, encoder_ffn_embed_dim=480,
                   encoder_attention_heads=2, conv_pos_groups=2)
NS = 4000


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads (see test_torch_train)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_pair(**over):
    """The narrow model, JAX-initialised (seed 0, fp32) and carried into the
    port by the converter with a strict load."""
    enc_kw = dict(_over(WIDE_NARROW), **NO_DROPOUT)
    kw = {"vocab_size": VOCAB, "apply_mask": False, **over}
    jcfg = JCtcConfig(encoder=jax_large(**enc_kw), **kw)
    cfg = CtcFinetuneConfig(encoder=large_encoder_config(**enc_kw), **kw)
    enc = cfg.encoder
    assert enc.encoder_embed_dim // enc.encoder_attention_heads == 120
    assert enc.encoder_embed_dim // enc.conv_pos_groups == 120
    jmodel = JCtcModel(jcfg)
    k = jax.random.PRNGKey(0)
    params = to_numpy(jmodel.init({"params": k, "mask": k, "dropout": k},
                                  jnp.zeros((1, NS)), deterministic=True)["params"])
    model = CtcFinetuneModel(cfg)
    model.load_state_dict(ctc_state_dict_from_jax(params, cfg.encoder), strict=True)
    return jmodel, params, cfg, model


def test_wide_head_narrow_logits_match_jax():
    jmodel, params, cfg, model = build_pair()
    b = batch()
    jout = jmodel.apply({"params": params}, jnp.asarray(b["source"]),
                        jnp.asarray(b["lengths"]), deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(b["source"]), torch.from_numpy(b["lengths"]))
    np.testing.assert_array_equal(out.frame_lengths.numpy(), np.asarray(jout.frame_lengths))
    assert len(set(out.frame_lengths.tolist())) == len(b["lengths"])  # the batch is padded
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), rtol=1e-5,
                               atol=1e-5)


def test_wide_head_narrow_train_step_matches_jax():
    """One unfrozen make_train_step step against JAX's: loss, gradient norm
    and every tensor's gradient."""
    jmodel, params, cfg, model = build_pair(freeze_finetune_updates=0)
    opt = dict(lr=1e-3, schedule="fixed")
    tx = joptim.make_optimizer(joptim.OptimConfig(**opt))
    jstate = jax_create_state(params, tx)
    jstep = jax_make_step(jax_make_loss_fn(jmodel), tx, donate_state=False)
    state = create_train_state(model, optim.OptimConfig(**opt), device="cpu")
    step = make_train_step(make_ctc_finetune_loss_fn(model))
    b = batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss = jax_make_loss_fn(jmodel)
    grads = jax.grad(lambda p: (lambda l, ss, _: l / ss)(
        *jloss(p, jb, jax.random.PRNGKey(0), 0)))(jstate.params)
    jgrad = ctc_state_dict_from_jax(to_numpy(grads), cfg.encoder)
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrad.values()))
    jstate, jmet = jstep(jstate, jb, jax.random.PRNGKey(0))
    met = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
               torch.Generator().manual_seed(0))
    for k, rtol in (("loss_per_sample", 1e-5), ("grad_norm", 1e-4), ("sample_size", 0)):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol, err_msg=k)
    live = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # the conv frontend: feature_grad_mult 0
            assert not np.abs(jgrad[name].numpy()).any(), name
            continue
        g, wg = p.grad.numpy(), jgrad[name].numpy()
        assert np.linalg.norm(g - wg) <= 1e-4 * np.linalg.norm(wg) + 1e-6 * total, name
        live += ".self_attn." in name
    assert live == 2 * 8  # q/k/v/out weights and biases of both layers


def test_converter_at_xlsr2b_width():
    """The converters at XLS-R 2B's full width (one layer of 1920 in 16
    heads of 120, FFN 7680, the positional conv in 16 groups of 120): the
    port's state dict in the JAX layout has the JAX model's tree and shapes
    (from jax.eval_shape, no JAX weights made), and comes back through
    ctc_state_dict_from_jax with a strict load, every tensor equal."""
    enc_kw = dict(XLSR2B, encoder_layers=1, **NO_DROPOUT)
    kw = dict(vocab_size=32, apply_mask=False)
    cfg = CtcFinetuneConfig(encoder=large_encoder_config(**enc_kw), **kw)
    model = CtcFinetuneModel(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert tuple(sd["wavlm.encoder.layers.0.self_attn.q_proj.weight"].shape) == (1920, 1920)
    assert tuple(sd["wavlm.encoder.layers.0.fc1.weight"].shape) == (7680, 1920)
    assert tuple(sd["wavlm.encoder.pos_conv.0.weight_v"].shape) == (1920, 120, 128)
    params = jax_params_from_ctc_state_dict(sd, cfg.encoder)
    jmodel = JCtcModel(JCtcConfig(encoder=jax_large(**enc_kw), **kw))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": k, "mask": k, "dropout": k},
                                                jnp.zeros((1, 16000)),
                                                deterministic=True)["params"])
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): tuple(np.shape(v))
           for p, v in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want
    back = CtcFinetuneModel(cfg)
    back.load_state_dict(ctc_state_dict_from_jax(params, cfg.encoder), strict=True)
    for name, v in back.state_dict().items():
        assert torch.equal(v, sd[name]), name
