"""The port imports neither JAX nor the JAX package, and importing it builds
nothing: every module is imported, and a tiny CPU forward and a tiny
pretraining step run, in a fresh interpreter, which must end with no ``jax``
and no ``unispeech_tpu.`` module loaded and no kernel library built."""

import subprocess
import sys
import textwrap
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import torch
    import unispeech_tpu_torch
    from unispeech_tpu_torch.ops.kernels import _build

    for m in pkgutil.walk_packages(unispeech_tpu_torch.__path__, "unispeech_tpu_torch."):
        importlib.import_module(m.name)

    from unispeech_tpu_torch.configs import WavLMModelConfig, eval_conv_spec, base_encoder_config
    from unispeech_tpu_torch.models.wavlm import WavLM

    enc = base_encoder_config(
        encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
        encoder_attention_heads=2, conv_layers=eval_conv_spec("[(32,10,5)] + [(32,3,2)] * 2"),
        conv_pos=8, conv_pos_groups=2, relative_position_embedding=True,
        gru_rel_pos=True, num_buckets=16, max_distance=32)
    model = WavLM(WavLMModelConfig(encoder=enc), generator=torch.Generator().manual_seed(0))
    out = model.extract_features(torch.randn(2, 2000), lengths=torch.tensor([2000, 1500]))
    assert out.x.shape == (2, 99, 32) and torch.isfinite(out.x).all()

    from unispeech_tpu_torch.configs import HubertPretrainConfig
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    import dataclasses
    hub = HubertPretrainModel(HubertPretrainConfig(
        encoder=dataclasses.replace(enc, encoder_layerdrop=0.1), num_classes=(5,), final_dim=8),
        generator=torch.Generator().manual_seed(0))
    state = create_train_state(hub, OptimConfig(schedule="fixed"), device="cpu")
    step = make_train_step(make_hubert_loss_fn(hub, HubertCriterionConfig()))
    met = step(state, {"source": torch.randn(2, 2000),
                       "targets": torch.randint(0, 5, (2, 99, 1))},
               torch.Generator().manual_seed(1))
    assert torch.isfinite(met["loss_per_sample"]) and state.step == 1

    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m.startswith("unispeech_tpu."))
    assert not bad, bad
    assert _build._lib is None
    print("ok")
""")


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
