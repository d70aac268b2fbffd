"""The port imports neither JAX nor the JAX package, and importing it builds
nothing: every module is imported, and a tiny CPU forward, a tiny
pretraining step (and one with the UniSpeech-SAT branch), a UniSpeech
multitask step, a frozen and an unfrozen CTC fine-tuning step, a beam
decode run, and the ECAPA-TDNN and diarization heads' forwards on the
tiny features, in a fresh interpreter, which must end with no ``jax`` and no
``unispeech_tpu.`` module loaded, no kernel library (CUDA or native host)
built, and no process group made."""

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

    names = set()
    for m in pkgutil.walk_packages(unispeech_tpu_torch.__path__, "unispeech_tpu_torch."):
        importlib.import_module(m.name)
        names.add(m.name)
    pipeline = {"data.__main__", "data.batching", "data.dataset", "data.labels",
                "data.mixing", "data.prefetch", "tools.kmeans", "train.checkpoint",
                "train.loop", "train.__main__", "utils.debug", "utils.metrics",
                "data.dictionary", "data.text_encoders", "decode", "decode.__main__",
                "decode.arpa", "decode.beam", "decode.wer", "models.ctc", "ops.ctc",
                "train.tasks", "ops.quantizer", "models.wav2vec2", "data.multilingual",
                "convert.fairseq", "downstream", "downstream.ecapa_tdnn",
                "downstream.diarization", "downstream.verification", "downstream.diarize",
                "parallel", "parallel.bootstrap", "parallel.sharding",
                "parallel.tensor_parallel", "native", "data.s2t", "data.chunk_stream",
                "data.feats"}
    missing = {"unispeech_tpu_torch." + n for n in pipeline} - names
    assert not missing, missing

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

    sat = HubertPretrainModel(HubertPretrainConfig(
        encoder=enc, num_classes=(5,), final_dim=8, utterance_contrastive_loss=True,
        utterance_contrastive_layer=1, num_instances=1, quantize_targets=True),
        generator=torch.Generator().manual_seed(0))
    state = create_train_state(sat, OptimConfig(schedule="fixed"), device="cpu")
    step = make_train_step(make_hubert_loss_fn(sat, HubertCriterionConfig(
        spk_loss_weight=0.1, prob_ppl_weight=0.1)))
    met = step(state, {"source": torch.randn(2, 2000),
                       "targets": torch.randint(0, 5, (2, 99, 1))},
               torch.Generator().manual_seed(1))
    assert torch.isfinite(met["loss_per_sample"]) and "loss_spk_m" in met

    from unispeech_tpu_torch.configs import GumbelVQConfig, Wav2Vec2PretrainConfig
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
    from unispeech_tpu_torch.train.tasks import make_wav2vec2_loss_fn

    w2v = Wav2Vec2PretrainModel(Wav2Vec2PretrainConfig(
        encoder=enc, final_dim=8, num_negatives=4, quantizer=GumbelVQConfig(num_vars=6, vq_dim=8),
        transpose=True, ctc_vocab_size=7), generator=torch.Generator().manual_seed(0))
    state = create_train_state(w2v, OptimConfig(schedule="fixed"), device="cpu")
    step = make_train_step(make_wav2vec2_loss_fn(w2v, mtlalpha=0.5))
    met = step(state, {"source": torch.randn(2, 2000), "lengths": torch.tensor([2000, 1500]),
                       "labels": torch.tensor([[5, 6, 4], [2, 4, 1]]),
                       "label_lengths": torch.tensor([3, 2])}, torch.Generator().manual_seed(1))
    assert torch.isfinite(met["loss_per_sample"]) and "loss_ctc" in met

    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.decode.beam import CtcBeamDecoder
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel
    from unispeech_tpu_torch.train.tasks import make_ctc_finetune_loss_fn

    d = Dictionary.letters()
    ctc = CtcFinetuneModel(CtcFinetuneConfig(encoder=enc, vocab_size=len(d),
                                             freeze_finetune_updates=1, final_dropout=0.1),
                           generator=torch.Generator().manual_seed(0))
    state = create_train_state(ctc, OptimConfig(schedule="fixed"), device="cpu")
    step = make_train_step(make_ctc_finetune_loss_fn(ctc))
    b = {"source": torch.randn(2, 2000), "lengths": torch.tensor([2000, 1500]),
         "labels": torch.tensor([[5, 6, 4], [7, 4, 1]]), "label_lengths": torch.tensor([3, 2])}
    for _ in range(2):  # one frozen step, one not
        met = step(state, b, torch.Generator().manual_seed(1))
        assert torch.isfinite(met["loss_per_sample"])
    lp = torch.log_softmax(ctc(b["source"], b["lengths"]).logits, -1)[0].detach().numpy()
    assert CtcBeamDecoder(beam=4).decode(lp)

    from unispeech_tpu_torch.downstream.diarization import (
        DiarizationConfig, TransformerDiarization)
    from unispeech_tpu_torch.downstream.ecapa_tdnn import EcapaConfig, EcapaTdnn

    head = EcapaTdnn(EcapaConfig(channels=16, emb_dim=8, scale=4, num_layer_feats=3), 32,
                     generator=torch.Generator().manual_seed(0)).eval()
    out = model.extract_features(torch.randn(2, 2000), lengths=torch.tensor([2000, 1500]),
                                 collect_layer_outputs=True)
    emb = head(out.layer_outputs, out.padding_mask)
    assert emb.shape == (2, 8) and torch.isfinite(emb).all()
    dia = TransformerDiarization(DiarizationConfig(num_speakers=2, hidden_dim=16, num_layers=1,
                                                   num_heads=2, ffn_dim=32, emb_dim=8), 32,
                                 generator=torch.Generator().manual_seed(0))
    res = dia(out.x, out.padding_mask)
    assert res.logits.shape == (2, 99, 2) and torch.isfinite(res.logits).all()

    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m.startswith("unispeech_tpu."))
    assert not bad, bad
    assert _build._lib is None
    from unispeech_tpu_torch import native
    assert native._lib is None
    import torch.distributed as dist
    assert not dist.is_initialized()
    print("ok")
""")


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
