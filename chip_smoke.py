#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (one NVIDIA H100): build, check, drive.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1 device   the card's name and power limit; TF32 off for the plain versions
  2 build    nvcc builds the port's kernels from unispeech_tpu_torch/csrc
  3 parity   each forward kernel against its plain PyTorch version, on the
             card, at the shapes the serving path gives it, in bf16; the L1
             forward with and without its sums also at the pretraining
             shape, at (k, stride) = (10, 5) and (8, 4)
  4 main     WavLM-Base+ (random weights from a seed, bf16) extract_features
             on a padded batch of 4 utterances (16/12/7/3 s), full depth and
             output_layer=6; launch counts per forward; the kernel path held
             against the same model with the three ops' plain versions
  5 large    WavLM-Large (the config dump-features --arch large builds:
             layer_norm extractor, pre-LN, normalized input; 24 layers,
             width 1024; random weights from a seed, bf16) extract_features
             on the same batch: the conv blocks in the extractor's form
             against their plain versions, launch counts per forward, the
             kernel path against the plain path, forward ms, host enqueue
             ms, audio-seconds per second, peak memory
  6 cli      python -m unispeech_tpu_torch.tools dump-features --feature model
             on a manifest of wav files and a params .npz in the JAX layout
  7 bwd      each backward kernel, and the attention forward with dropout,
             against its plain version at the pretraining shapes (6 crops of
             245,840 samples, 768 frames, two rows padded for attention);
             then in WavLM-Large's forms at its shapes (3 crops, width 1024,
             16 heads): the L1 backward without the sums' cotangents, the
             conv blocks' backward in the layer_norm extractor's form (input
             GELU, no affine, no output GELU), attention forward with
             dropout and backward, one of its rows of length 0
  8 train    WavLM-Base masked-prediction pretraining (the bench's config,
             full width and depth, random weights from a seed) on 6 crops of
             245,840 samples: 3 steps of make_train_step with launch counts
             per step; one step's gradients, kernel path against plain path;
             20 steps on one batch, the loss must fall
    large_train  the same for WavLM-Large (the bench's Large config: 24
             layers, width 1024, final_dim 768) on 3 crops of 245,840 samples
    ctc_train  CTC fine-tuning at WavLM-Large's full width (the model
             finetune-ctc --arch large builds, masks and dropouts on, the
             letter dictionary, bf16), its backbone grafted from a seed-0
             HubertPretrainModel at the bench's Large config, on the padded
             smoke batch with random letter transcripts (15 symbols per
             second): 5 steps, the first 2 frozen, with launch counts per
             step (no L1 or conv backward, no attention backward while
             frozen, zero frontend gradients); one unfrozen step's
             gradients, kernel path against plain path; 20 unfrozen steps,
             the loss must fall; a batch with an infeasible and a
             zero-length row (both rows' loss and logit gradient 0)
    pipeline HuBERT-style pretraining from raw audio through the CLIs, called
             in-process: 12 wav files of 3-12 s, data manifest, tools
             dump-features --feature mfcc, learn-kmeans (100 clusters),
             dump-labels, train pretrain-hubert --arch large (4 updates,
             checkpoints every 2, params export), the same resumed to 6
             updates, then model features of the export at layer 12,
             k-means and labels; launch counts of the training runs, label
             frame counts, finite losses, the resume at update 4
    ctc_pipeline  train finetune-ctc --arch large --w2v-path <the pipeline's
             export> on letter transcripts of the 12 files (valid set the
             same, --best-metric wer, freeze 2, checkpoints every 2) to
             update 2, resumed to 4; decode --arch large with the viterbi
             decoder, the kenlm decoder (a tiny ARPA LM and lexicon) and the
             ensemble of both exports; finite losses, a valid WER at each
             validation, the best checkpoint by WER, the resume, one
             hypothesis per file, the WER report, attention backward only
             from update 3 on
    s2s_train  seq2seq fine-tuning at WavLM-Large's full width (the model
             finetune-seq2seq --arch large builds: the encoder as ctc_train,
             the default decoder 768 wide, 3072 FFN, 6 layers, 4 heads,
             enc_proj, the letter dictionary, bf16), grafted as ctc_train,
             on the padded smoke batch with random letter transcripts: 5
             steps, the first 2 frozen, with launch counts per step; one
             unfrozen step's gradients, kernel path against plain path; a
             batch with a zero-length row, finite; step ms, host enqueue,
             peak memory, a profiled unfrozen step; greedy and beam decoding
             (K = 5, no-repeat-ngram 3, max_len 64) with ms per call, beam
             K = 1 equal to greedy, the beams sorted and distinct; 20
             unfrozen steps on one batch, the loss must fall; then a GLU +
             iPQ noise (quant_noise_pq 0.1) encoder at width 1024 and depth
             4: its forward, kernel path against plain path, 3 finite train
             steps, the share of dropped blocks within 4 sigma of p
    lm_train the TransformerLM train-lm builds (512 wide, 2048 FFN, 6
             layers, 8 heads; block 128, batch 32; bf16) on a synthetic Zipf
             corpus: 20 steps, the loss must fall; step ms, tokens/s; the
             NeuralLMScorer on the card against the CPU, fp32, rtol 1e-4
    s2s_pipeline  train finetune-seq2seq --arch large --w2v-path <the
             pipeline's export> (valid WER, --best-metric wer, freeze 2,
             --valid-decode-max-len 32) to update 2, resumed to 4; data
             binarize-text on a word corpus and train train-lm from the .bin
             (10 updates, --export-params); decode --decoder seq2seq of the
             seq2seq export and --decoder neural of ctc_pipeline's export
             with the lexicon and the LM; finite losses, a WER at each
             validation, the resume, one hypothesis per file, the WER
             reports, seconds per call
    w2v_train  UniSpeech pretraining at WavLM-Large's width
             (Wav2Vec2PretrainModel: no relative position bias, transpose
             mode, Gumbel 2 x 320, 100 negatives, final_dim and vq_dim 768,
             the letter CTC head, replace_prob 0.5, mtlalpha 0.5, bf16) on
             the padded smoke batch with random letter transcripts: 3 steps
             with launch counts per step (L1 1/1 without the sums, conv
             12/18, attention 48/48 in the no-bias form with remat_layers),
             the quantizer's temperature and perplexities; one step's
             gradients, kernel path against plain path, the same generator
             seed, the codeword choices pinned; 20 steps, the loss must fall;
             step ms, host enqueue, audio-seconds per second, peak memory
    sat_train  the same for UniSpeech-SAT at the bench's Large config with
             pretrain-hubert --sat's speaker branch (1 + 100 instances, spk
             loss weight 0.1) on random frame labels; loss_spk_m and
             contrastive_acc per step
    w2v_pipeline  train pretrain-wav2vec2 --arch large --mtlalpha 0.5 on the
             pipeline's 12 files as two comma-separated "language"
             manifests (--multilang-alpha 0.5) with letter transcripts, to
             update 2, resumed to 4; then pretrain-hubert --arch large --sat
             on the pipeline's MFCC labels for 2 updates; finite losses, the
             resume, every kernel family launched
  9 vpu      the elementwise micro-benchmark's entry point
             (python -m unispeech_tpu_torch.scripts.exp_vpu_micro) at
             (6, 49152, 512) bf16 with launch counts; each of its seven
             variants against its plain version; per-variant times
 10 times    each kernel (forward at the serving shapes, backward and the
             dropout forward at the pretraining shapes; the conv backward
             per block with dx and dW apart), its plain version, its bound
             and one PyTorch library call; the kernel's wrapper and the library
             call timed by CUDA events as the host enqueues them (wall: a
             call of several launches follows the host) and queued behind
             a busy card (device); the attention backward on the padded
             fine-tuning batch (16 heads); the attention forward and backward
             without bias on that batch with dropout (rows 1nLp, 2nLp, per
             w2v_train step); each kernel family's launches per frozen and
             unfrozen fine-tuning step (CTC and seq2seq); audio-seconds per
             second of the forward, of the train steps, of the fine-tuning
             steps and of the UniSpeech and UniSpeech-SAT steps

The line before the last is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.kernels import BF16_TC_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S

REPO = pathlib.Path(__file__).resolve().parent
SAMPLE_RATE = 16_000
UTTERANCE_SECONDS = (16, 12, 7, 3)
SEED = 0
# pretraining batch: the bench's crop (768 frames) x the reference's per-GPU batch
TRAIN_B, TRAIN_NS, N_CLASSES = 6, 245_840, 504
LARGE_B = 3  # the bench's Large batch (bench.py, B = 3)

# one bf16 ulp at a tensor's scale: two fp32 accumulation orders may round
# a value to neighbouring bf16 numbers (8 significant bits)
BF16_ULP = 2.0 ** -7
# a train step's gradients, kernel path against plain path, per parameter
# tensor: |g - g_plain| <= GRAD_TOL |g_plain| + GRAD_FLOOR |global gradient|.
# The two paths round to bf16 at other places (the online softmax's P, dS,
# the conv pre-activations) through 12 layers forward and back; the floor
# covers gradients that are zero analytically (the k_proj bias: softmax
# ignores a per-query constant), noise on both paths.
GRAD_TOL, GRAD_FLOOR = 5e-2, 1e-4
# draws of a contrastive step's randomness whose gradients the kernel-vs-plain
# check of w2v_train and sat_train stacks: one draw's ratio of the two paths'
# fp32 errors on a noise-led tensor spreads over 0.5-4 on an H100; stacked
# over 16 draws the gate read 0.82 of its tolerance there
GRAD_DRAWS = 16


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


class PhaseClock:
    """Prints the seconds each phase took."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        phase("seconds", phase=name, seconds=f"{now - self.t:.1f}")
        self.t = now


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Relative L2 of an fp32 sum against its plain version; returns the max
    abs error."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    diff = float((got.float() - want.float()).norm())
    ref = float(want.float().norm())
    phase("parity", kernel=name, rel_l2=f"{diff / max(ref, 1e-30):.3g}", tol=tol)
    if not diff <= tol * ref:
        fail(f"{name}: relative L2 {diff / max(ref, 1e-30)} > {tol}")
    return float((got.float() - want.float()).abs().max())


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol_ulps: float = 1.0) -> float:
    """Max |got - want| against tol_ulps bf16 ulps at want's scale."""
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = float((got.float() - want.float()).abs().max())
    tol = tol_ulps * BF16_ULP * float(want.float().abs().max())
    phase("parity", kernel=name, max_abs_err=f"{err:.6g}", tol=f"{tol:.6g}",
          rel_l2=f"{rel_l2(got, want):.3g}")
    if not err <= tol:
        fail(f"{name}: max abs err {err} > {tol}")
    return err


def compare_each(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Each |got - want| against one bf16 ulp of that element of want;
    returns the max abs error."""
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    over = int((diff > torch.exp2(torch.floor(torch.log2(mag)) - 7)).sum())
    err = float(diff.max())
    phase("parity", kernel=name, max_abs_err=f"{err:.6g}", tol="1_bf16_ulp_per_element",
          over_tol=over, unequal=int((diff != 0).sum()))
    if over:
        fail(f"{name}: {over} elements differ by more than one bf16 ulp")
    return err


def smoke_batch(device):
    """4 utterances of 16/12/7/3 s of noise, zero-padded to 16 s."""
    gen = torch.Generator().manual_seed(SEED)
    ns = max(UTTERANCE_SECONDS) * SAMPLE_RATE
    lengths = torch.tensor([s * SAMPLE_RATE for s in UTTERANCE_SECONDS])
    wav = torch.randn(len(lengths), ns, generator=gen) * 0.1
    wav = wav * (torch.arange(ns)[None, :] < lengths[:, None])
    return wav.to(device), lengths.to(device)


def device_us(event) -> float:
    return (getattr(event, "self_device_time_total", 0)
            or getattr(event, "self_cuda_time_total", 0))


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call: the card spins in a sleep kernel while the
    host enqueues ``iters`` calls behind it, so CUDA events bracket their
    execution back to back, without the host's gaps between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    # twice the host time of a synchronised run, in cycles at >= 2 GHz:
    # longer than the enqueue takes
    cycles = int(2 * (time.perf_counter() - t0) * 2e9)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_times(fn):
    """(wall ms, device ms) of a library call: CUDA events around calls
    enqueued as the host goes, and around calls queued behind a busy card."""
    return cuda_ms(fn), device_ms(fn)


def grad_fn(outputs, inputs, grads):
    """torch.autograd.grad of a retained graph: a library backward."""
    return lambda: torch.autograd.grad(outputs, inputs, grads, retain_graph=True)


@contextlib.contextmanager
def plain_ops():
    """The model with the three ops replaced by their plain versions: the
    same code path otherwise, so the two runs differ only in the kernels."""
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

    saved = (encoder.l1_conv_with_stats, encoder.conv_gelu_block, encoder.fused_attention)
    encoder.l1_conv_with_stats = l1_frontend.l1_conv_with_stats_plain
    encoder.conv_gelu_block = conv_stack.conv_gelu_block_plain
    encoder.fused_attention = flash_attention.fused_attention_plain
    try:
        yield
    finally:
        encoder.l1_conv_with_stats, encoder.conv_gelu_block, encoder.fused_attention = saved


def l1_forward_parity(dev, wav, w1, s0):
    """Both instantiations of the L1 forward (with and without the sums)
    against the plain version: at the serving batch with the main path's
    (k, stride), and at the pretraining shape with it and, through the
    generic instantiation, with (8, 4). y1 within one bf16 ulp at its scale;
    the sums, fp32 over t1 rows in two orders (per-lane rows, shuffles and
    per-block atomics vs the library reduction), within 1e-4 of the sum of
    |terms|; one launch per call, no sums without them. Returns y1's max abs
    error with and without the sums."""
    from unispeech_tpu_torch.ops.kernels import l1_frontend

    gen = torch.Generator().manual_seed(SEED + 6)
    C = w1.shape[2]
    wav_t = (torch.randn(TRAIN_B, TRAIN_NS, generator=gen) * 0.1).to(dev)
    w8 = (torch.randn(8, 1, C, generator=gen) * 0.5).to(dev)
    err = {True: 0.0, False: 0.0}
    for tag, x, w, s in (("serving", wav, w1, s0), ("pretraining", wav_t, w1, s0),
                         ("pretraining.k8s4", wav_t, w8, 4)):
        py, ps1, ps2, pt1 = l1_frontend.l1_conv_with_stats_plain(x, w, s)
        for stats in (True, False):
            name = f"l1_conv_with_stats.{tag}" + ("" if stats else ".no_sums")
            before = l1_frontend.launches
            y, s1, s2, t1 = l1_frontend.l1_conv_with_stats(x, w, s, with_stats=stats)
            torch.cuda.synchronize()
            if l1_frontend.launches != before + 1 or t1 != pt1:
                fail(f"{name}: {l1_frontend.launches - before} launches, t1 {t1} != {pt1}")
            err[stats] = max(err[stats], compare(f"{name}.y1", y, py))
            if not stats:
                if s1 is not None or s2 is not None:
                    fail(f"{name}: sums returned")
                continue
            for nm, got, want, mag in (("s1", s1, ps1, py.float().abs().sum(1)),
                                       ("s2", s2, ps2, py.float().square().sum(1))):
                e = float(((got - want).abs() / mag).max())
                phase("parity", kernel=f"{name}.{nm}", max_rel_to_sum_abs=f"{e:.3g}",
                      tol="1e-4")
                if not e <= 1e-4:
                    fail(f"{name}.{nm}: {e}")
            del y, s1, s2
        del py, ps1, ps2
    return err[True], err[False]


def large_phase(dev, wav, lengths, card):
    """Phase 5: WavLM-Large feature extraction on the card. Returns the
    launch counts of one forward and the conv blocks' max abs error."""
    from unispeech_tpu_torch.configs import WavLMModelConfig, large_encoder_config
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

    # the config dump-features --arch large builds
    cfg = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True, dropout=0.0,
                               attention_dropout=0.0, encoder_layerdrop=0.0)
    B, NS = wav.shape
    gen = torch.Generator().manual_seed(SEED + 7)
    C, k0, s0 = cfg.conv_layers[0]
    # each block as the layer_norm extractor runs it (input GELU, no affine,
    # no output GELU), at the serving shapes, a LayerNorm between blocks
    x = torch.randn(B, (NS - k0) // s0 + 1, C, generator=gen).to(dev, torch.bfloat16)
    err_conv = 0.0
    for i, (dim, k, _) in enumerate(cfg.conv_layers[1:], start=2):
        w = (torch.randn(k, C, dim, generator=gen) * (2.0 / (k * C)) ** 0.5).to(
            dev, torch.bfloat16)
        y, _ = conv_stack.conv_gelu_block(x, w, x.shape[1], True, False, None)
        py, _ = conv_stack.conv_gelu_block_plain(x, w, x.shape[1], True, False, None)
        torch.cuda.synchronize()
        err_conv = max(err_conv, compare(f"conv_gelu_block.layer_norm_form.L{i}", y, py))
        x = F.layer_norm(py.float(), (dim,)).to(torch.bfloat16)
    del x, y, py

    model = WavLM(WavLMModelConfig(encoder=cfg), dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    nparams = sum(p.numel() for p in model.parameters())
    counters = (l1_frontend, conv_stack, flash_attention)
    for c in counters:
        c.launches = 0
    out = model.extract_features(wav, lengths=lengths).x
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    # L1 without the sums; every conv block has the input GELU: its H pass
    # and its GEMM; one attention call per layer
    want = (1, 2 * (len(cfg.conv_layers) - 1), cfg.encoder_layers)
    n_frames, D = cfg.num_frames(NS), cfg.encoder_embed_dim
    if out.shape != (B, n_frames, D) or not torch.isfinite(out).all():
        fail(f"large: output {tuple(out.shape)} not finite (B, {n_frames}, {D})")
    if launches != want:
        fail(f"large: launches (l1, conv, attention) {launches} != {want}")
    with plain_ops():
        plain_x = model.extract_features(wav, lengths=lengths).x
    # bf16 rounding differences of the two paths through 24 layers
    e = rel_l2(out, plain_x)
    del out, plain_x

    fwd_ms = cuda_ms(lambda: model.extract_features(wav, lengths=lengths), iters=5, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.extract_features(wav, lengths=lengths)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.extract_features(wav, lengths=lengths)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_ms, wall_ms, _ = profile_once(lambda: model.extract_features(wav, lengths=lengths),
                                       "large_profile")
    audio_s = float(lengths.sum()) / SAMPLE_RATE
    phase("large", params=nparams, shape=(B, n_frames, D), launches=launches,
          rel_l2_vs_plain=f"{e:.3g}", tol="5e-2", forward_ms=f"{fwd_ms:.3f}",
          host_enqueue_ms=f"{host_ms:.3f}", audio_seconds=audio_s,
          audio_sec_per_s=f"{audio_s / (fwd_ms / 1e3):.1f}", peak_memory_gb=f"{peak_gb:.2f}",
          profiled_busy_ms=f"{busy_ms:.3f}", profiled_wall_ms=f"{wall_ms:.3f}",
          card=card.replace(" ", "_"))
    if not e <= 5e-2:
        fail("large: kernel path disagrees with the plain path")
    return dict(launches=launches, err_conv=err_conv)


def backward_parity(dev, cfg, B=TRAIN_B, ln_form=False):
    """Phase 7: each backward kernel (and the attention forward with dropout)
    against its plain version at the pretraining shapes of ``cfg`` with B
    crops. ``ln_form``: the forms WavLM-Large's layer_norm extractor runs
    (the L1 backward without the sums' cotangents; every conv block with
    the input GELU, no affine and no output GELU). Returns the inputs the
    times phase reuses and the max abs errors."""
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    gen = torch.Generator().manual_seed(SEED + 2 + 10 * ln_form)
    NS = TRAIN_NS
    sfx = ".ln_form" if ln_form else ""
    C = cfg.conv_layers[0][0]
    k0, s0 = cfg.conv_layers[0][1:]
    t1 = (NS - k0) // s0 + 1
    wav = (torch.randn(B, NS, generator=gen) * 0.1).to(dev)
    w1 = (torch.randn(k0, 1, C, generator=gen) * (2.0 / k0) ** 0.5).to(dev)
    dy1 = (torch.randn(B, t1, C, generator=gen) * 1e-3).to(dev, torch.bfloat16)
    ds1 = ds2 = None
    if not ln_form:
        ds1 = (torch.randn(B, C, generator=gen) * 1e-4).to(dev)
        ds2 = (torch.randn(B, C, generator=gen) * 1e-4).to(dev)
    l1_args = (wav, w1, s0, dy1, ds1, ds2)
    # fp32 sums over B * t1 rows (295,002 at B = 6) in two orders (per-thread
    # rows and cross-tile atomics vs one einsum): relative L2 1e-3
    err_l1 = rel_check("l1_conv_backward.dw" + (".no_sums" if ln_form else ""),
                       l1_frontend.l1_conv_backward(*l1_args),
                       l1_frontend.l1_conv_backward_plain(*l1_args), 1e-3)
    if not ln_form:
        # a second geometry, (k, stride) = (8, 4), through the kernel's
        # generic instantiation at a pretraining-sized t1 (61,459 rows)
        t8 = (NS - 8) // 4 + 1
        gen8 = torch.Generator().manual_seed(SEED + 5)
        args8 = (wav, (torch.randn(8, 1, C, generator=gen8) * 0.5).to(dev), 4,
                 (torch.randn(B, t8, C, generator=gen8) * 1e-3).to(dev, torch.bfloat16),
                 ds1, ds2)
        rel_check("l1_conv_backward.dw.k8s4", l1_frontend.l1_conv_backward(*args8),
                  l1_frontend.l1_conv_backward_plain(*args8), 1e-3)
        del args8

    conv_args = []  # (x, w, valid, gelu_in, gelu_out, affine, dy, pre) per block
    x = torch.randn(B, t1, C, generator=gen).to(dev, torch.bfloat16)
    affine = ((torch.rand(B, C, generator=gen) + 0.5).to(dev),
              (torch.randn(B, C, generator=gen) * 0.1).to(dev))
    err_conv = 0.0
    for i, (dim, k, _) in enumerate(cfg.conv_layers[1:], start=2):
        w = (torch.randn(k, C, dim, generator=gen) * (2.0 / (k * C)) ** 0.5).to(
            dev, torch.bfloat16)
        # the default extractor: the first block takes the GroupNorm affine
        # and the first GELU; every block ends in a GELU. The layer_norm
        # extractor: every block takes the previous LayerNorm's GELU
        gelu_in, gelu_out = (True, False) if ln_form else (i == 2, True)
        ab = affine if (i == 2 and not ln_form) else None
        y, t_out, pre = conv_stack._forward(x, w, x.shape[1], gelu_in, gelu_out, ab,
                                            want_pre=gelu_out)
        if gelu_out:
            _, _, ppre = conv_stack.conv_gelu_block_plain(x, w, x.shape[1], gelu_in, gelu_out,
                                                          ab, return_pre=True)
            compare(f"conv_gelu_block.L{i}.pre", pre, ppre)
        dy = (torch.randn(B, t_out, C, generator=gen) * 1e-2).to(dev, torch.bfloat16)
        args = (x, w, x.shape[1], gelu_in, gelu_out, ab, dy, pre)
        conv_args.append(args)
        got = conv_stack.conv_gelu_block_backward(*args)
        want = conv_stack.conv_gelu_block_backward_plain(*args)
        torch.cuda.synchronize()
        err_conv = max(err_conv, compare(f"conv_gelu_block_backward{sfx}.L{i}.dx", got[0],
                                         want[0], tol_ulps=2.0))
        rel_check(f"conv_gelu_block_backward{sfx}.L{i}.dw", got[1], want[1], 1e-3)
        if ab is not None:
            rel_check("conv_gelu_block_backward.L2.da", got[2], want[2], 1e-3)
            rel_check("conv_gelu_block_backward.L2.db", got[3], want[3], 1e-3)
        # the next block's input: the LayerNorm of y in the layer_norm form
        x = F.layer_norm(y.float(), (dim,)).to(torch.bfloat16) if ln_form else y

    T = x.shape[1]
    H, D = cfg.encoder_attention_heads, cfg.encoder_embed_dim
    sfx = f".h{H}" if ln_form else ""
    q, kk, v = (torch.randn(B, T, H, D // H, generator=gen).to(dev, torch.bfloat16)
                for _ in range(3))
    table = (torch.randn(cfg.num_buckets, H, generator=gen) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table, T, T, cfg.num_buckets, cfg.max_distance,
                                dtype=torch.bfloat16)
    gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
    # two rows padded; in the layer_norm form one of them has length 0, as the
    # fixed-shape batches' padding rows do
    frames = torch.tensor([T] * (B - 2) + ([T - 168, 0] if ln_form else [T - 68, T - 168]),
                          device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    seed = torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64).to(dev)
    rate = cfg.attention_dropout
    fwd = dict(bias=bias, gate=gate, key_padding_mask=kpm, dropout_rate=rate,
               dropout_seed=seed)
    out, lse = flash_attention.fused_attention(q, kk, v, **fwd, return_lse=True)
    pout, plse = flash_attention.fused_attention_plain(q, kk, v, **fwd, return_lse=True)
    torch.cuda.synchronize()
    # the keep masks are bit-identical; the online softmax rounds P against
    # a running max: 2 bf16 ulps
    err_drop = compare(f"fused_attention.dropout{sfx}", out, pout, tol_ulps=2.0)
    # a row of length 0 has the mask value as its lse (-2^100 in the kernel,
    # -1e30 in the plain version): lse is held on the rows with a key
    e_lse = float((lse - plse)[frames > 0].abs().max())
    phase("parity", kernel=f"fused_attention.dropout{sfx}.lse", max_abs_err=f"{e_lse:.3g}",
          tol="1e-3")
    if not e_lse <= 1e-3:
        fail(f"lse with dropout{sfx}: {e_lse}")
    # no loss term reaches a row of length 0, so training's dO is 0 there
    # (with p recomputed from the mask-valued lse, the backward of such a row
    # is exact only then); both backwards take the plain forward's out and lse
    dout = (torch.randn(B, T, H, D // H, generator=gen) * 1e-2
            * (frames.cpu() > 0)[:, None, None, None]).to(dev, torch.bfloat16)
    attn_args = (q, kk, v, bias, gate, kpm, None, rate, seed, pout, plse, dout)
    got = flash_attention.fused_attention_backward(*attn_args)
    want = flash_attention.fused_attention_backward_plain(*attn_args)
    torch.cuda.synchronize()
    err_attn = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err_attn = max(err_attn, compare(f"fused_attention_backward{sfx}.{name}", a, b,
                                         tol_ulps=2.0))
    # fp32 sums whose order varies (atomics over key tiles and the batch)
    rel_check(f"fused_attention_backward{sfx}.dbias", got[3], want[3], 2e-3)
    rel_check(f"fused_attention_backward{sfx}.dgate", got[4], want[4], 2e-3)
    return dict(l1=l1_args, conv=conv_args, attn=attn_args, fwd_drop=(q, kk, v, fwd),
                err=(err_l1, err_conv, err_attn, err_drop), ln_form=ln_form)


def train_phase(dev, counters, train_counts, arch="base"):
    """Phase 8 (arch "base") and large_train (arch "large"): masked-prediction
    pretraining steps on the card. Fills ``train_counts`` with the launch
    counts of the first step; returns the end-to-end numbers."""
    import dataclasses

    from unispeech_tpu_torch.configs import (
        HubertPretrainConfig,
        MaskConfig,
        base_encoder_config,
        large_encoder_config,
    )
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    tag = "train" if arch == "base" else "large_train"
    # the bench's configuration (bench.py build_step)
    enc_fn = base_encoder_config if arch == "base" else large_encoder_config
    enc = enc_fn(relative_position_embedding=True, gru_rel_pos=True,
                 encoder_layerdrop=0.05, dropout=0.1, attention_dropout=0.1,
                 remat_ffn=True, remat_layers=False, scan_layers=False)
    pcfg = HubertPretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.8, mask_length=10),
                                num_classes=(N_CLASSES,),
                                final_dim=256 if arch == "base" else 768)
    crit = HubertCriterionConfig()
    B, NS = (TRAIN_B if arch == "base" else LARGE_B), TRAIN_NS
    T = enc.num_frames(NS)
    gen = torch.Generator().manual_seed(SEED + 3)
    batch = {"source": torch.randn(B, NS, generator=gen).to(dev),
             "targets": torch.randint(0, N_CLASSES, (B, T, 1), generator=gen).to(dev)}
    model = HubertPretrainModel(pcfg, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, OptimConfig(lr=5e-4, warmup_steps=100, total_steps=1000),
                               device=dev)
    step = make_train_step(make_hubert_loss_fn(model, crit))
    L = enc.encoder_layers
    before = [p.detach().clone() for p in model.parameters()]

    def reset():
        for m, attr in counters:
            setattr(m, attr, 0)

    for i in range(3):
        reset()
        met = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = tuple(getattr(m, attr) for m, attr in counters)
        kept = L - met["layers_dropped"]
        # conv kernels, the default extractor: the six blocks forward 6 GEMMs
        # + the first block's H pass, backward 6 x (g pass, dx, dW) + that H
        # pass; the layer_norm extractor: every block forward an H pass (its
        # input GELU) and the GEMM, backward the H pass, dx and dW (no output
        # GELU, so no g pass). Each attention backward: its rows pre-pass
        # and the backward kernel
        conv = (7, 19) if arch == "base" else (12, 18)
        want = (1, 1) + conv + (kept, 2 * kept)
        loss, gnorm = float(met["loss_per_sample"]), float(met["grad_norm"])
        phase(tag, step=i, loss_per_sample=f"{loss:.4f}", grad_norm=f"{gnorm:.4f}",
              sample_size=int(met["sample_size"]), layers_dropped=met["layers_dropped"],
              launches_l1_conv_attn_fwd_bwd=counts)
        if counts != want:
            fail(f"{tag} step {i}: launches {counts} != {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"{tag} step {i}: loss {loss}, grad_norm {gnorm}")
        if i == 0 and i not in train_counts:
            train_counts.update(zip(("l1", "l1_bwd", "conv", "conv_bwd", "attn", "attn_bwd"),
                                    counts))
        if i == 0 and any(not torch.equal(a, p) for a, p in zip(before, model.parameters())):
            fail("step 0 has learning rate 0 but changed the parameters")
    if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
        fail("the parameters did not change by step 2")
    del before

    # one step's gradients, kernel path against plain path: dropout and
    # layerdrop off, one fixed mask, the same weights
    enc0 = dataclasses.replace(enc, dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0)
    model0 = HubertPretrainModel(dataclasses.replace(pcfg, encoder=enc0), dtype=torch.bfloat16)
    model0.load_state_dict(model.state_dict())
    model0 = model0.to(dev)
    batch0 = dict(batch, boundary_mask=(torch.rand(B, T, generator=gen) < 0.5).to(dev))
    loss_fn0 = make_hubert_loss_fn(model0, crit)

    def grads():
        model0.zero_grad(set_to_none=True)
        loss, ss, _ = loss_fn0(batch0, torch.Generator(), 0)
        (loss / torch.clamp(ss, min=1.0)).backward()
        return [p.grad.float().clone() for p in model0.parameters()]

    gk = grads()
    with plain_ops():
        gp = grads()
    total = float(torch.sqrt(sum((g * g).sum() for g in gp)))
    worst = []
    for (name, _), a, b in zip(model0.named_parameters(), gk, gp):
        diff, ref = float((a - b).norm()), float(b.norm())
        worst.append((diff / (GRAD_TOL * ref + GRAD_FLOOR * total), name, diff / max(ref, 1e-30)))
    worst.sort(reverse=True)
    for ratio, name, rel in worst[:5]:
        phase(tag, grad_vs_plain=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{ratio:.3g}")
    phase(tag, grad_tol=f"{GRAD_TOL} * |g| + {GRAD_FLOOR} * |global|",
          global_grad_norm=f"{total:.4g}", tensors=len(worst))
    if worst[0][0] > 1.0:
        fail(f"{tag}: gradient of {worst[0][1]}: kernel path disagrees with the plain path")
    del model0, gk, gp

    # ms per step, host enqueue, audio-sec/s, peak memory; a profiled step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_time = 5
    t0 = time.perf_counter()
    for _ in range(n_time):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_time
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    step(state, batch, gen)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    busy_ms, wall_ms, n_launch = profile_once(lambda: step(state, batch, gen), f"{tag}_profile")

    # learning: 20 steps on one batch at a fixed learning rate
    state = create_train_state(model, OptimConfig(lr=5e-4, schedule="fixed"), device=dev)
    losses = []
    for _ in range(20):
        losses.append(step(state, batch, gen)["loss_per_sample"])
    losses = [float(x) for x in losses]
    phase(tag, learning_first=f"{losses[0]:.4f}", learning_last=f"{losses[-1]:.4f}",
          steps=len(losses))
    if not losses[-1] < losses[0]:
        fail(f"{tag}: 20 steps on one batch: loss {losses[0]} -> {losses[-1]} did not fall")
    audio_s = B * NS / SAMPLE_RATE
    return dict(step_ms=step_ms, host_ms=host_ms, peak_gb=peak_gb, audio_s=audio_s,
                busy_ms=busy_ms, wall_ms=wall_ms, launches=n_launch)


def profile_once(fn, tag):
    """Device busy time, wall time and kernel launches of one call, and the
    top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device kernels only: the aten ops that launch them carry the same time
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    phase(tag, wall_ms=f"{wall_ms:.3f}", kernel_busy_ms=f"{busy_ms:.3f}",
          idle_share=f"{1 - busy_ms / wall_ms:.3f}", kernel_launches=n_launch)
    for e in events[:15]:
        phase(tag, kernel=e.key[:60].replace(" ", "_"), calls=e.count,
              device_ms=f"{device_us(e) / 1e3:.4f}")
    host_ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host_ops[:6]:
        phase(tag, host_op=e.key[:40], calls=e.count,
              self_cpu_ms=f"{e.self_cpu_time_total / 1e3:.3f}")
    return busy_ms, wall_ms, n_launch


def library_row(fn, n: int = 1):
    """The library keys of a kernels row: n calls' wall and device ms."""
    wall, dev = library_times(fn)
    return dict(library_ms=n * wall, library_device_ms=n * dev)


def bound(nbytes: float, flops: float, peak: float):
    """(bound ms, what bounds it) for the bytes moved and the operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def backward_times(bw, train_counts):
    """The kernels rows of the three backward kernels, and of the attention
    forward with dropout, at the pretraining shapes of ``bw`` (Base's, or
    WavLM-Large's forms with ``bw["ln_form"]``), per train step (all launches
    of a kernel in one step)."""
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

    err_l1, err_conv, err_attn, err_drop = bw["err"]
    ln_form = bw["ln_form"]
    wav, w1, s0, dy1, ds1, ds2 = bw["l1"]
    B, NS = wav.shape
    k0, _, C = w1.shape
    t1 = dy1.shape[1]
    xb = wav.to(torch.bfloat16)[:, None, :]
    wl = w1.permute(2, 1, 0).to(torch.bfloat16).contiguous().requires_grad_()
    yl = F.conv1d(xb, wl, stride=s0)
    # with the sums' cotangents the kernel recomputes y1 (2 B t1 C k more
    # operations) and reads ds1, ds2; without them dW = wav-windows^T dy alone
    l1_bound = bound(B * t1 * C * 2 + B * NS * 4 + k0 * C * 4
                     + (0 if ds1 is None else 2 * B * C * 4),
                     (2 if ds1 is None else 4) * B * t1 * C * k0, FP32_FLOPS)
    H = bw["attn"][0].shape[2]
    rows = [dict(
        name="l1_conv_backward" + (".no_sums" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/l1_frontend.cu",
        replaces="unispeech_tpu/ops/pallas/l1_frontend.py:203",
        launches=train_counts["l1_bwd"], max_abs_err=err_l1,
        ms=cuda_ms(lambda: l1_frontend.l1_conv_backward(*bw["l1"])),
        device_ms=device_ms(lambda: l1_frontend.l1_conv_backward(*bw["l1"])),
        plain_ms=cuda_ms(lambda: l1_frontend.l1_conv_backward_plain(*bw["l1"]), iters=3,
                         warmup=1),
        bound_ms=l1_bound[0], bound_by=l1_bound[1],
        **library_row(grad_fn(yl, wl, dy1.transpose(1, 2).contiguous())),
    )]
    c_ms = c_dev = c_plain = c_lib = c_bound = 0.0
    c_lib_dev = 0.0
    c_by = set()
    for i, args in enumerate(bw["conv"], start=2):
        x, w, valid, gelu_in, gelu_out, ab, dy, pre = args
        k = w.shape[0]
        t_out = dy.shape[1]
        c_ms += cuda_ms(lambda: conv_stack.conv_gelu_block_backward(*args))
        one_dev = device_ms(lambda: conv_stack.conv_gelu_block_backward(*args))
        c_dev += one_dev
        # dx and dW apart: the device time of calls that launch one GEMM past
        # the g and H passes, less that of calls that launch neither
        part_ms = [device_ms(lambda: conv_stack.backward_parts(*args, parts))
                   for parts in (0, conv_stack.BWD_DX, conv_stack.BWD_DW)]
        split = [part_ms[1] - part_ms[0], part_ms[2] - part_ms[0]]
        if not min(split) > 0:
            fail(f"conv block L{i}: no device time of dx or dW ({split})")
        gemm_flops = 2 * B * t_out * C * k * C  # each of dx and dW
        phase("times", kernel=f"conv_gelu_block_backward{'.ln_form' if ln_form else ''}.L{i}",
              device_ms=f"{one_dev:.4f}",
              tflops=f"{2 * gemm_flops / one_dev / 1e9:.1f}",
              dx_device_ms=f"{split[0]:.4f}", dx_tflops=f"{gemm_flops / split[0] / 1e9:.1f}",
              dw_device_ms=f"{split[1]:.4f}", dw_tflops=f"{gemm_flops / split[1] / 1e9:.1f}")
        c_plain += cuda_ms(lambda: conv_stack.conv_gelu_block_backward_plain(*args), iters=2,
                           warmup=1)
        xt = x.transpose(1, 2).contiguous().requires_grad_()
        wt = w.permute(2, 1, 0).contiguous().requires_grad_()
        yt = F.conv1d(xt, wt, stride=2)
        lib = library_times(grad_fn(yt, (xt, wt), dy.transpose(1, 2).contiguous()))
        c_lib += lib[0]
        c_lib_dev += lib[1]
        b_ms, by = bound((2 * B * x.shape[1] * C + 2 * k * C * C + 2 * B * t_out * C) * 2
                         + k * C * C * 4, 2 * 2 * B * t_out * C * k * C, BF16_TC_FLOPS)
        c_bound += b_ms
        c_by.add(by)
    rows.append(dict(
        name="conv_gelu_block_backward" + (".layer_norm_form" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/conv_stack.cu",
        replaces="unispeech_tpu/ops/pallas/conv_stack.py:359",
        launches=train_counts["conv_bwd"], max_abs_err=err_conv, ms=c_ms, device_ms=c_dev,
        plain_ms=c_plain,
        bound_ms=c_bound, bound_by="operations" if "operations" in c_by else "bytes",
        library_ms=c_lib, library_device_ms=c_lib_dev))
    q, kk, v, bias, gate, kpm, _, rate, seed, out, lse, dout = bw["attn"]
    B, T, H, hd = q.shape
    n = train_counts["attn"]  # backward calls: one per forward call
    a_bound = bound(8 * B * T * H * hd * 2 + 2 * H * T * T * 2 + 3 * B * H * T * 4 + B * T,
                    10 * B * H * T * T * hd, BF16_TC_FLOPS)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kk, v))
    mask = (gate[..., None] * bias.float()[None]
            + torch.where(kpm, -1e30, 0.0)[:, None, None, :]).to(torch.bfloat16).requires_grad_()
    ya = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    rows.append(dict(
        name="fused_attention_backward" + (f".h{H}" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:1159",
        launches=train_counts["attn_bwd"], max_abs_err=err_attn,
        ms=n * cuda_ms(lambda: flash_attention.fused_attention_backward(*bw["attn"])),
        device_ms=n * device_ms(lambda: flash_attention.fused_attention_backward(*bw["attn"])),
        plain_ms=n * cuda_ms(lambda: flash_attention.fused_attention_backward_plain(*bw["attn"]),
                             iters=2, warmup=1),
        bound_ms=n * a_bound[0], bound_by=a_bound[1],
        **library_row(grad_fn(ya, (qh, kh, vh, mask), dout.transpose(1, 2).contiguous()), n),
    ))
    # where the backward's time goes: one call without dropout, without the
    # gated bias, without either (same shapes and key padding)
    q, kk, v, bias, gate, kpm, amask, rate, seed, out, lse, dout = bw["attn"]
    for tag, args in (("no_dropout", (q, kk, v, bias, gate, kpm, amask, 0.0, None)),
                      ("no_bias", (q, kk, v, None, None, kpm, amask, rate, seed)),
                      ("neither", (q, kk, v, None, None, kpm, amask, 0.0, None))):
        if ln_form:
            break
        one = cuda_ms(lambda: flash_attention.fused_attention_backward(*args, out, lse, dout))
        phase("times", kernel=f"fused_attention_backward.{tag}", ms_per_call=f"{one:.4f}")
    # the dropout forward at the pretraining shape, per train step; SDPA with
    # the same dropout rate is the library call (it draws another mask)
    q, kk, v, fwd = bw["fwd_drop"]
    B, T, H, hd = q.shape
    d_bound = bound(4 * B * T * H * hd * 2 + H * T * T * 2 + 2 * B * H * T * 4 + B * T,
                    4 * B * H * T * T * hd, BF16_TC_FLOPS)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kk, v))
    dmask = (fwd["gate"][..., None] * fwd["bias"].float()[None]
             + torch.where(fwd["key_padding_mask"], -1e30, 0.0)[:, None, None, :]).to(
                 torch.bfloat16)
    rows.append(dict(
        name="fused_attention.dropout" + (f".h{H}" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention.cu",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:878",
        launches=train_counts["attn"], max_abs_err=err_drop,
        ms=n * cuda_ms(lambda: flash_attention.fused_attention(q, kk, v, **fwd)),
        device_ms=n * device_ms(lambda: flash_attention.fused_attention(q, kk, v, **fwd)),
        plain_ms=n * cuda_ms(lambda: flash_attention.fused_attention_plain(q, kk, v, **fwd),
                             iters=2, warmup=1),
        bound_ms=n * d_bound[0], bound_by=d_bound[1],
        **library_row(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=dmask, dropout_p=fwd["dropout_rate"]), n),
    ))
    return rows


VPU_SHAPE = (6, 49152, 512)  # the L2 conv block's input at the pretraining crop
VPU_ITERS = 50


def vpu_phase(dev):
    """Phase 9: the micro-benchmark's entry point at its full shape with the
    launch count read around it, then each variant against its plain
    version on the same input. Returns the kernels row."""
    from unispeech_tpu_torch.ops.kernels import vpu_micro
    from unispeech_tpu_torch.scripts import exp_vpu_micro

    vpu_micro.launches = 0
    times = exp_vpu_micro.main(["--shape", ",".join(map(str, VPU_SHAPE)),
                                "--iters", str(VPU_ITERS)])
    torch.cuda.synchronize()
    launches = vpu_micro.launches
    want = len(vpu_micro.VARIANTS) * (VPU_ITERS + 1)  # a warm-up and the timed passes
    phase("vpu", launches=launches, want=want)
    if launches != want:
        fail(f"vpu_micro: {launches} launches, want {want}")

    x = torch.randn(VPU_SHAPE, generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev, dtype=torch.bfloat16)
    one_bound = exp_vpu_micro.bound_ms(x.numel())
    y = torch.empty_like(x)
    library = {  # one PyTorch call for the same (or, for the GELUs, the nearest) function
        "copy": lambda: y.copy_(x), "exp": lambda: torch.exp(x),
        "gelu_poly8": lambda: F.gelu(x), "gelu_poly6c": lambda: F.gelu(x),
        "gelu_AS_exp": lambda: F.gelu(x),
    }
    err, plain, lib, lib_dev, dev_sum = 0.0, 0.0, 0.0, 0.0, 0.0
    for name in vpu_micro.VARIANTS:
        before = vpu_micro.launches
        got = vpu_micro.run(name, x)
        if vpu_micro.launches != before + 1:
            fail(f"vpu_micro.{name}: the kernel's count did not move")
        err = max(err, compare_each(f"vpu_micro.{name}", got, vpu_micro.run_plain(name, x)))
        del got
        dev_sum += device_ms(lambda: vpu_micro.run(name, x))
        p_ms = cuda_ms(lambda: vpu_micro.run_plain(name, x), iters=3, warmup=1)
        plain += p_ms
        l_ms = l_dev = None
        if name in library:
            l_ms, l_dev = library_times(library[name])
            lib += l_ms
            lib_dev += l_dev
        phase("vpu", variant=name, ms=f"{times[name]:.4f}", plain_ms=f"{p_ms:.4f}",
              library_ms="null" if l_ms is None else f"{l_ms:.4f}",
              library_device_ms="null" if l_dev is None else f"{l_dev:.4f}",
              bound_ms=f"{one_bound:.4f}", bound_share=f"{one_bound / times[name]:.3f}")
    return dict(
        name="vpu_micro", route="cuda", source="unispeech_tpu_torch/csrc/vpu_micro.cu",
        replaces="scripts/exp_vpu_micro.py:31", launches=launches, max_abs_err=err,
        ms=sum(times.values()), device_ms=dev_sum, plain_ms=plain,
        bound_ms=len(times) * one_bound,
        bound_by="bytes", library_ms=lib, library_device_ms=lib_dev)


def write_wav(path: pathlib.Path, samples: np.ndarray) -> None:
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


PIPE_FILES, PIPE_SECONDS, PIPE_CLUSTERS, PIPE_LAYER = 12, (3.0, 12.0), 100, 12


def pipeline_phase(counters, tmp):
    """HuBERT-style pretraining from raw audio through the CLIs' main(argv),
    in-process so the launch counters can be read: manifest -> MFCC ->
    k-means -> labels -> pretrain-hubert --arch large (4 updates, then
    resumed to 6) -> model features of the export -> k-means -> labels.
    Works in ``tmp`` and leaves the wav files, the manifest and the export
    there for ctc_pipeline."""
    import io

    from unispeech_tpu_torch.configs import large_encoder_config
    from unispeech_tpu_torch.data.__main__ import main as data_main
    from unispeech_tpu_torch.tools.__main__ import main as tools_main
    from unispeech_tpu_torch.train.__main__ import main as train_main

    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(SEED + 9)
    sizes = [int(rng.uniform(*PIPE_SECONDS) * SAMPLE_RATE) for _ in range(PIPE_FILES)]
    for i, n in enumerate(sizes):
        # a tone that changes every 0.25 s over noise: frames k-means can tell apart
        seg = np.repeat(rng.uniform(100, 3000, n // 4000 + 1), 4000)[:n]
        t = np.arange(n) / SAMPLE_RATE
        write_wav(tmp / "wavs" / f"utt{i:02d}.wav",
                  0.3 * np.sin(2 * np.pi * seg * t) + 0.05 * rng.standard_normal(n))
    man = str(tmp / "man" / "train.tsv")
    lab = tmp / "lab"
    ckpt, export = str(tmp / "ckpt"), str(tmp / "export.npz")
    mfcc_frames = [1 + (n - 400) // 160 for n in sizes]
    model_frames = [large_encoder_config().num_frames(n) for n in sizes]

    def timed(name, fn, argv):
        t0 = time.perf_counter()
        fn(argv)
        torch.cuda.synchronize()
        phase("pipeline", step=name, seconds=f"{time.perf_counter() - t0:.2f}")

    def check_labels(stem, want, what):
        lines = (lab / f"{stem}.km").read_text().splitlines()
        got = [len(line.split()) for line in lines]
        phase("pipeline", labels=what, utterances=len(lines), frames=sum(got))
        if got != want:
            fail(f"pipeline: {what} label frames {got} != {want}")
        if max(int(x) for line in lines for x in line.split()) >= PIPE_CLUSTERS:
            fail(f"pipeline: {what} label out of range")

    def train(max_updates):
        argv = ["pretrain-hubert", "--manifest", man, "--labels", str(lab / "mfcc.km"),
                "--arch", "large", "--num-classes", str(PIPE_CLUSTERS), "--label-rate", "100",
                "--mixing-prob", "0.2", "--max-updates", str(max_updates),
                "--save-interval-updates", "2", "--log-interval", "1",
                "--checkpoint-dir", ckpt, "--export-params", export]
        for m, attr in counters:
            setattr(m, attr, 0)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            train_main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tuple(getattr(m, attr) for m, attr in counters)
        records = [json.loads(line) for line in log.getvalue().splitlines()
                   if line.startswith('{"tag": "train"')]
        for r in records:
            phase("pipeline", update=r["step"], wall_s=r["elapsed_s"], loss=r["loss_avg"],
                  sample_size=r["sample_size"], layers_dropped=r["layers_dropped"])
        phase("pipeline", step=f"pretrain-hubert --max-updates {max_updates}",
              seconds=f"{seconds:.2f}", launches_l1_conv_attn_fwd_bwd=counts)
        if not all(counts):
            fail(f"pipeline: a kernel family was not launched in training: {counts}")
        if not all(np.isfinite(r["loss_avg"]) for r in records):
            fail("pipeline: a non-finite loss")
        return [r["step"] for r in records]

    timed("data manifest", data_main, ["manifest", str(tmp / "wavs"), "--ext", "wav",
                                       "--valid-percent", "0", "--dest", str(tmp / "man")])
    timed("dump-features mfcc", tools_main,
          ["dump-features", "--feature", "mfcc", "--manifest", man,
           "--feat-dir", str(tmp / "mfcc")])
    timed("learn-kmeans mfcc", tools_main,
          ["learn-kmeans", "--feat-dir", str(tmp / "mfcc"), "--n-clusters",
           str(PIPE_CLUSTERS), "--km-path", str(tmp / "km_mfcc.npy")])
    timed("dump-labels mfcc", tools_main,
          ["dump-labels", "--manifest", man, "--km-path", str(tmp / "km_mfcc.npy"),
           "--lab-dir", str(lab)])
    (lab / "train_0_1.km").rename(lab / "mfcc.km")
    check_labels("mfcc", mfcc_frames, "mfcc")
    first = train(4)
    second = train(6)
    phase("pipeline", first_run_updates=first, resumed_run_updates=second,
          checkpoints=sorted(int(n) for n in os.listdir(ckpt)))
    if first != [1, 2, 3, 4] or second != [5, 6]:
        fail(f"pipeline: the resumed run did not start at update 4: {first}, {second}")
    model_args = ["--feature", "model", "--arch", "large", "--checkpoint", export,
                  "--layer", str(PIPE_LAYER)]
    timed("dump-features model", tools_main,
          ["dump-features", "--manifest", man, "--feat-dir", str(tmp / "model"),
           *model_args])
    timed("learn-kmeans model", tools_main,
          ["learn-kmeans", "--feat-dir", str(tmp / "model"), "--n-clusters",
           str(PIPE_CLUSTERS), "--km-path", str(tmp / "km_model.npy")])
    timed("dump-labels model", tools_main,
          ["dump-labels", "--manifest", man, "--km-path", str(tmp / "km_model.npy"),
           "--lab-dir", str(lab), *model_args])
    check_labels("train_0_1", model_frames, "model")
    shutil.rmtree(ckpt, ignore_errors=True)  # 11 GB of pretraining checkpoints


LETTERS = "| E T A O N I H S R D L U M W C F G Y P B V K ' X J Q Z".split()
CHARS_PER_SECOND = 15  # LibriSpeech's transcript rate


def letter_transcript(rng, seconds: float) -> str:
    """Random words of 2-7 letters in the letter format ("A B | C D |"),
    about CHARS_PER_SECOND symbols per second of audio."""
    units = []
    while len(units) < int(seconds * CHARS_PER_SECOND):
        units += list(rng.choice(LETTERS[1:], int(rng.integers(2, 8)))) + ["|"]
    return " ".join(units)


def ctc_finetune_config(freeze: int):
    """The CtcFinetuneModel finetune-ctc --arch large builds: WavLM-Large's
    encoder with the gated relative position bias (dropout 0.1, attention
    dropout 0.1, remat_layers), time mask 0.65/10, channel mask 0.5/64,
    final dropout 0.1, the letter dictionary."""
    from unispeech_tpu_torch.configs import MaskConfig, large_encoder_config
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig

    enc = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True)
    return CtcFinetuneConfig(encoder=enc, vocab_size=len(LETTERS) + 4, apply_mask=True,
                             time_mask=MaskConfig(mask_prob=0.65, mask_length=10),
                             freeze_finetune_updates=freeze, final_dropout=0.1)


CTC_FREEZE, CTC_STEPS = 2, 5


def ctc_train_phase(dev, counters, ctc_counts, wav, lengths):
    """ctc_train: CTC fine-tuning at WavLM-Large's full width on the smoke
    batch (4 utterances of 16/12/7/3 s padded to 16 s, random letter
    transcripts at 15 symbols per second). The backbone is grafted from a
    seed-0 HubertPretrainModel at the bench's Large config. 5 steps with
    freeze_finetune_updates = 2 and launch counts per step; one unfrozen
    step's gradients, kernel path against plain path; zero frontend
    gradients; 20 unfrozen steps on one batch, the loss must fall; a batch
    with an infeasible row and a zero-length row. Fills ``ctc_counts`` with
    the launch counts of a frozen and an unfrozen step; returns the
    end-to-end numbers and the padded attention backward's inputs."""
    import dataclasses

    from unispeech_tpu_torch.configs import (
        HubertPretrainConfig,
        MaskConfig,
        large_encoder_config,
    )
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.ctc import CtcFinetuneModel, load_pretrained_into
    from unispeech_tpu_torch.models.encoder import reset_parameters
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.ops.ctc import ctc_loss
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_ctc_finetune_loss_fn

    d = Dictionary.letters()
    if d.symbols[4:] != LETTERS:
        fail("ctc_train: the letter dictionary changed")
    cfg = ctc_finetune_config(CTC_FREEZE)
    model = CtcFinetuneModel(cfg, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(SEED + 11))
    # the graft at full size: the bench's Large pretraining model, seed 0
    penc = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                                encoder_layerdrop=0.05, remat_layers=False, scan_layers=False)
    pre = HubertPretrainModel(HubertPretrainConfig(
        encoder=penc, time_mask=MaskConfig(mask_prob=0.8, mask_length=10),
        num_classes=(N_CLASSES,), final_dim=768), generator=torch.Generator().manual_seed(SEED))
    load_pretrained_into(model, pre.state_dict())
    backbone = dict(pre.state_dict())
    if any(not torch.equal(v, backbone[k]) for k, v in model.wavlm.state_dict().items()):
        fail("ctc_train: the graft did not carry the pretrained backbone")
    del pre, backbone
    nparams = sum(p.numel() for p in model.parameters())

    B = wav.shape[0]
    rng = np.random.default_rng(SEED + 12)
    texts = [letter_transcript(rng, float(n) / SAMPLE_RATE) for n in lengths.cpu()]
    enc_texts = [d.encode_line(t) for t in texts]
    S = int(np.ceil(max(len(e) for e in enc_texts) / 8) * 8)
    labels = np.full((B, S), d.pad(), np.int32)
    for r, e in enumerate(enc_texts):
        labels[r, :len(e)] = e
    batch = {"source": wav, "lengths": lengths.to(torch.int32),
             "labels": torch.from_numpy(labels).to(dev),
             "label_lengths": torch.tensor([len(e) for e in enc_texts], dtype=torch.int32,
                                           device=dev)}
    state = create_train_state(model, OptimConfig(lr=5e-5, warmup_steps=2, total_steps=100,
                                                  schedule="tri_stage", hold_steps=40),
                               device=dev)
    step = make_train_step(make_ctc_finetune_loss_fn(model))
    gen = torch.Generator().manual_seed(SEED + 13)
    L = cfg.encoder.encoder_layers
    frontend = [p for n, p in model.named_parameters()
                if n.startswith("wavlm.feature_extractor.")]
    backbone_before = [p.detach().clone() for n, p in model.named_parameters()
                       if n.startswith("wavlm.encoder.layers.")][:4]

    def reset():
        for m, attr in counters:
            setattr(m, attr, 0)

    for i in range(CTC_STEPS):
        reset()
        frozen = model.frozen(state.step)
        met = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = tuple(getattr(m, attr) for m, attr in counters)
        kept = L - met["layers_dropped"]
        # forward: L1 without the sums, every block's H pass and GEMM,
        # attention once per kept layer (frozen: the backbone runs without
        # autograd) or twice (remat_layers recomputes each layer in the
        # backward); backward: no L1 or conv kernel (feature_grad_mult = 0),
        # attention's pre-pass and kernel per kept layer once unfrozen
        want = (1, 0, 12, 0) + ((kept, 0) if frozen else (2 * kept, 2 * kept))
        loss, gnorm = float(met["loss_per_sample"]), float(met["grad_norm"])
        phase("ctc_train", step=i, frozen=frozen, loss_per_token=f"{loss:.4f}",
              grad_norm=f"{gnorm:.4f}", ntokens=int(met["sample_size"]),
              layers_dropped=met["layers_dropped"],
              launches_l1_conv_attn_fwd_bwd=counts)
        if counts != want:
            fail(f"ctc_train step {i}: launches {counts} != {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"ctc_train step {i}: loss {loss}, grad_norm {gnorm}")
        ctc_counts.setdefault("frozen" if frozen else "unfrozen", counts)
        if any(p.grad is None or p.grad.any() for p in frontend):
            fail(f"ctc_train step {i}: a frontend parameter got a nonzero gradient")
    moved = [not torch.equal(a, p) for a, p in zip(
        backbone_before, [p for n, p in model.named_parameters()
                          if n.startswith("wavlm.encoder.layers.")][:4])]
    if not all(moved):
        fail("ctc_train: the backbone did not move")
    del backbone_before

    # one unfrozen step's gradients, kernel path against plain path: no
    # masks, no dropout (the eval loss), the same weights
    loss_eval = make_ctc_finetune_loss_fn(model, deterministic=True)

    def grads():
        model.zero_grad(set_to_none=True)
        loss, ss, _ = loss_eval(batch, None, CTC_FREEZE)
        (loss / torch.clamp(ss, min=1.0)).backward()
        return [torch.zeros_like(p) if p.grad is None else p.grad.float().clone()
                for p in model.parameters()]

    gk = grads()
    with plain_ops():
        gp = grads()
    total = float(torch.sqrt(sum((g * g).sum() for g in gp)))
    worst = []
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        diff, ref = float((a - b).norm()), float(b.norm())
        worst.append((diff / (GRAD_TOL * ref + GRAD_FLOOR * total), name, diff / max(ref, 1e-30)))
    worst.sort(reverse=True)
    for ratio, name, rel in worst[:5]:
        phase("ctc_train", grad_vs_plain=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{ratio:.3g}")
    phase("ctc_train", grad_tol=f"{GRAD_TOL} * |g| + {GRAD_FLOOR} * |global|",
          global_grad_norm=f"{total:.4g}", tensors=len(worst))
    if worst[0][0] > 1.0:
        fail(f"ctc_train: gradient of {worst[0][1]}: kernel path disagrees with the plain path")
    if any(g.any() for (n, _), g in zip(model.named_parameters(), gk)
           if n.startswith("wavlm.feature_extractor.")):
        fail("ctc_train: the frontend got a gradient")
    del gk, gp
    model.zero_grad(set_to_none=True)

    # an infeasible row (labels longer than its frames) and a zero-length
    # padding row: a finite loss; both rows' loss and logit gradient are 0
    crafted = {k: v.clone() for k, v in batch.items()}
    short = int(lengths[-1])  # the 3 s row
    n_short = cfg.encoder.num_frames(short)
    crafted["labels"][-1] = torch.from_numpy(np.resize(labels[0], S)).to(dev)
    crafted["label_lengths"][-1] = min(S, n_short + 50)
    crafted["source"][2] = 0.0
    crafted["lengths"][2] = 0
    crafted["labels"][2] = d.pad()
    crafted["label_lengths"][2] = 0
    if not int(crafted["label_lengths"][-1]) > n_short:
        fail("ctc_train: the crafted row is feasible")
    out = model(crafted["source"], crafted["lengths"], deterministic=True, step=CTC_FREEZE)
    logits = out.logits.detach().requires_grad_()
    total_loss, _ = ctc_loss(logits, out.frame_lengths, crafted["labels"],
                             crafted["label_lengths"])
    total_loss.backward()
    rows = [float(ctc_loss(logits[r:r + 1].detach(), out.frame_lengths[r:r + 1],
                           crafted["labels"][r:r + 1], crafted["label_lengths"][r:r + 1])[0])
            for r in range(B)]
    gmax = [float(logits.grad[r].abs().max()) for r in range(B)]
    total_loss = float(total_loss.detach())
    phase("ctc_train", crafted_loss=f"{total_loss:.4f}",
          per_row=[f"{x:.4f}" for x in rows], grad_max_per_row=[f"{x:.3g}" for x in gmax],
          frames=out.frame_lengths.tolist(), labels=crafted["label_lengths"].tolist())
    if not (np.isfinite(total_loss) and rows[2] == 0.0 and rows[3] == 0.0
            and gmax[2] == 0.0 and gmax[3] == 0.0 and rows[0] > 0 and gmax[0] > 0):
        fail("ctc_train: the infeasible or zero-length row is not 0, or the loss not finite")
    met = step(state, crafted, gen)
    if not (np.isfinite(float(met["loss_per_sample"])) and np.isfinite(float(met["grad_norm"]))):
        fail("ctc_train: a train step on the crafted batch is not finite")
    del logits, out

    # ms per step (back to back), host enqueue on an idle queue, peak
    # memory, and one profiled step, frozen and unfrozen
    def timed(frozen, n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state.step = 0 if frozen else CTC_FREEZE
            step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        state.step = 0 if frozen else CTC_FREEZE
        t0 = time.perf_counter()
        step(state, batch, gen)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        state.step = 0 if frozen else CTC_FREEZE
        prof = profile_once(lambda: step(state, batch, gen),
                            f"ctc_{'frozen' if frozen else 'unfrozen'}_profile")
        return ms, host, prof

    frozen_ms, host_frozen, frozen_prof = timed(True)
    torch.cuda.reset_peak_memory_stats()
    unfrozen_ms, host_unfrozen, unfrozen_prof = timed(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # learning: 20 unfrozen steps on one batch at a fixed learning rate, from
    # a fresh head (the steps above have already taken the loss to the
    # plateau where the head emits mostly blanks)
    fresh = torch.nn.Linear(model.proj.in_features, model.proj.out_features)
    reset_parameters(fresh, torch.Generator().manual_seed(SEED + 16))
    model.proj.load_state_dict(fresh.state_dict())
    state = create_train_state(model, OptimConfig(lr=5e-5, schedule="fixed"), device=dev)
    state.step = CTC_FREEZE
    losses = [step(state, batch, gen)["loss_per_sample"] for _ in range(20)]
    losses = [float(x) for x in losses]
    phase("ctc_train", learning_first=f"{losses[0]:.4f}", learning_last=f"{losses[-1]:.4f}",
          steps=len(losses), losses=",".join(f"{x:.3f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"ctc_train: 20 steps on one batch: loss {losses[0]} -> {losses[-1]} did not fall")
    audio_s = float(lengths.sum()) / SAMPLE_RATE
    return dict(params=nparams, frozen_ms=frozen_ms, unfrozen_ms=unfrozen_ms,
                host_frozen_ms=host_frozen, host_unfrozen_ms=host_unfrozen, peak_gb=peak_gb,
                audio_s=audio_s, frozen_profile=frozen_prof, unfrozen_profile=unfrozen_prof)


def finetune_attention_backward(dev, lengths, ctc_counts):
    """Row 2Lp: the attention backward at WavLM-Large's 16 heads on the
    fine-tuning batch (4 rows of 799 frames, 3 padded: 599/349/149 valid
    keys), dropout 0.1 regenerated, against its plain version (dq/dk/dv 2
    bf16 ulps, dbias/dgate relative L2 2e-3), with its bound, plain time
    and SDPA's backward, per unfrozen fine-tuning step."""
    from unispeech_tpu_torch.ops.kernels import flash_attention
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    enc = ctc_finetune_config(0).encoder
    gen = torch.Generator().manual_seed(SEED + 14)
    B, T = len(lengths), enc.num_frames(int(lengths.max()))
    H, D = enc.encoder_attention_heads, enc.encoder_embed_dim
    hd = D // H
    q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev, torch.bfloat16)
                for _ in range(3))
    table = (torch.randn(enc.num_buckets, H, generator=gen) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table, T, T, enc.num_buckets, enc.max_distance,
                                dtype=torch.bfloat16)
    gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
    frames = torch.tensor([enc.num_frames(int(n)) for n in lengths.cpu()], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    seed = torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64).to(dev)
    rate = enc.attention_dropout
    pout, plse = flash_attention.fused_attention_plain(
        q, kk, v, bias=bias, gate=gate, key_padding_mask=kpm, dropout_rate=rate,
        dropout_seed=seed, return_lse=True)
    dout = (torch.randn(B, T, H, hd, generator=gen) * 1e-2).to(dev, torch.bfloat16)
    args = (q, kk, v, bias, gate, kpm, None, rate, seed, pout, plse, dout)
    got = flash_attention.fused_attention_backward(*args)
    want = flash_attention.fused_attention_backward_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err = max(err, compare(f"fused_attention_backward.h{H}.padded.{name}", a, b,
                               tol_ulps=2.0))
    rel_check(f"fused_attention_backward.h{H}.padded.dbias", got[3], want[3], 2e-3)
    rel_check(f"fused_attention_backward.h{H}.padded.dgate", got[4], want[4], 2e-3)
    del got, want
    n = ctc_counts["unfrozen"][5] // 2  # backward calls per unfrozen step
    # what this batch needs: every query against the valid keys of its row
    # (five products), q/k/v/out/dO read and dq/dk/dv written once, the
    # bias read and dbias written once, lse/delta/gate
    keys = int(frames.sum())
    nbytes = 8 * B * T * H * hd * 2 + 2 * H * T * T * 2 + 3 * B * H * T * 4 + B * T
    b_ms, by = bound(nbytes, 10 * H * T * keys * hd, BF16_TC_FLOPS)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kk, v))
    mask = (gate[..., None] * bias.float()[None]
            + torch.where(kpm, -1e30, 0.0)[:, None, None, :]).to(torch.bfloat16).requires_grad_()
    ya = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    return dict(
        name=f"fused_attention_backward.h{H}.padded_finetune", route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:1159",
        launches=ctc_counts["unfrozen"][5], max_abs_err=err,
        ms=n * cuda_ms(lambda: flash_attention.fused_attention_backward(*args)),
        device_ms=n * device_ms(lambda: flash_attention.fused_attention_backward(*args)),
        plain_ms=n * cuda_ms(lambda: flash_attention.fused_attention_backward_plain(*args),
                             iters=2, warmup=1),
        bound_ms=n * b_ms, bound_by=by,
        **library_row(grad_fn(ya, (qh, kh, vh, mask), dout.transpose(1, 2).contiguous()), n))


def ctc_pipeline_phase(counters, tmp):
    """ctc_pipeline: CTC fine-tuning of the pipeline phase's WavLM-Large
    export and decoding to a WER, through the CLIs' main(argv) in-process:
    finetune-ctc --arch large --w2v-path <export> (letter transcripts of
    the 12 wav files, the same files as the valid set, --best-metric wer,
    freeze 2, checkpoints every 2) to update 2, resumed to update 4; then
    decode --arch large with the viterbi decoder, the kenlm decoder over a
    tiny ARPA LM and lexicon, and the ensemble of the update-2 and update-4
    exports. Returns the decodes' reports."""
    import io

    from unispeech_tpu_torch.decode.__main__ import main as decode_main
    from unispeech_tpu_torch.train.__main__ import main as train_main
    from unispeech_tpu_torch.train.checkpoint import CheckpointManager

    man = str(tmp / "man" / "train.tsv")
    sizes = [int(line.split("\t")[1]) for line in
             pathlib.Path(man).read_text().splitlines()[1:]]
    rng = np.random.default_rng(SEED + 15)
    texts = [letter_transcript(rng, n / SAMPLE_RATE) for n in sizes]
    ltr = tmp / "train.ltr"
    ltr.write_text("\n".join(texts) + "\n")
    # a lexicon (letters, no boundary) and a unigram ARPA LM over 40 of the words
    words = sorted({w.replace(" ", "") for t in texts for w in t.split("|") if w.strip()})[:40]
    (tmp / "lexicon.txt").write_text("".join(f"{w}\t{' '.join(w)}\n" for w in words))
    arpa = ["\\data\\", f"ngram 1={len(words) + 3}", "", "\\1-grams:", "-1.0\t<s>\t-0.3",
            "-1.0\t</s>", "-3.0\t<unk>"]
    arpa += [f"{-1.0 - 0.01 * i:.2f}\t{w}\t-0.2" for i, w in enumerate(words)]
    (tmp / "lm.arpa").write_text("\n".join(arpa + ["", "\\end\\", ""]))
    ckpt = str(tmp / "ctc_ckpt")
    export = str(tmp / "export.npz")

    def finetune(max_updates, out, want_valid):
        argv = ["finetune-ctc", "--manifest", man, "--transcripts", str(ltr),
                "--valid-manifest", man, "--valid-transcripts", str(ltr), "--arch", "large",
                "--w2v-path", export, "--best-metric", "wer", "--freeze-finetune-updates",
                str(CTC_FREEZE), "--save-interval-updates", "2", "--log-interval", "1",
                "--lr", "5e-5", "--warmup-steps", "2", "--max-updates", str(max_updates),
                "--checkpoint-dir", ckpt, "--export-params", str(tmp / out)]
        for m, attr in counters:
            setattr(m, attr, 0)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            train_main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tuple(getattr(m, attr) for m, attr in counters)
        lines = log.getvalue().splitlines()
        train = [json.loads(x) for x in lines if x.startswith('{"tag": "train"')]
        valid = [json.loads(x) for x in lines if x.startswith('{"tag": "valid"')]
        for r in train:
            phase("ctc_pipeline", update=r["step"], wall_s=r["elapsed_s"], loss=r["loss_avg"],
                  ntokens=r.get("ntokens"))
        for r in valid:
            phase("ctc_pipeline", valid_update=r["step"], loss=r["loss_avg"], wer=r.get("wer"),
                  uer=r.get("uer"))
        phase("ctc_pipeline", step=f"finetune-ctc --max-updates {max_updates}",
              seconds=f"{seconds:.2f}", launches_l1_conv_attn_fwd_bwd=counts)
        if not all(np.isfinite(r["loss_avg"]) for r in train + valid):
            fail("ctc_pipeline: a non-finite loss")
        if [r["step"] for r in valid] != want_valid or \
                not all("wer" in r and np.isfinite(r["wer"]) for r in valid):
            fail(f"ctc_pipeline: no valid WER at each validation: {valid}")
        if counts[1] or counts[3]:
            fail(f"ctc_pipeline: an L1 or conv backward kernel was launched: {counts}")
        if not (counts[0] and counts[2] and counts[4]):
            fail(f"ctc_pipeline: a forward kernel family was not launched: {counts}")
        return [r["step"] for r in train], counts, valid

    first, c_first, v_first = finetune(2, "ctc2.npz", [2])
    second, c_second, v_second = finetune(4, "ctc4.npz", [4])
    mgr = CheckpointManager(ckpt, best_metric="wer")
    best = mgr.best_step()
    wers = {r["step"]: r["wer"] for r in v_first + v_second}
    phase("ctc_pipeline", first_run_updates=first, resumed_run_updates=second,
          checkpoints=sorted(int(n) for n in os.listdir(ckpt)), best_step=best,
          valid_wer=wers)
    if first != [1, 2] or second != [3, 4]:
        fail(f"ctc_pipeline: the resumed run did not start at update 2: {first}, {second}")
    # the frozen updates 1-2 launch no attention backward; 3-4 do
    if c_first[5] != 0 or c_second[5] == 0:
        fail(f"ctc_pipeline: attention backward launches {c_first[5]}, {c_second[5]}")
    if best not in wers or wers[best] != min(wers.values()):
        fail(f"ctc_pipeline: the best checkpoint {best} is not the best WER {wers}")

    reports = {}
    for name, extra in (("viterbi", ["--checkpoint", str(tmp / "ctc4.npz")]),
                        ("kenlm", ["--checkpoint", str(tmp / "ctc4.npz"), "--decoder", "kenlm",
                                   "--lm-model", str(tmp / "lm.arpa"), "--lexicon",
                                   str(tmp / "lexicon.txt"), "--beam", "8"]),
                        ("ensemble", ["--checkpoint", str(tmp / "ctc2.npz"),
                                      str(tmp / "ctc4.npz")])):
        out = tmp / f"decode_{name}"
        for m, attr in counters:
            setattr(m, attr, 0)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            decode_main(["--manifest", man, "--transcripts", str(ltr), "--arch", "large",
                         "--results-path", str(out), *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tuple(getattr(m, attr) for m, attr in counters)
        rep = json.loads((out / "wer_report.json").read_text())
        hyps = (out / "hypo.word").read_text().splitlines()
        phase("ctc_pipeline", decode=name, seconds=f"{seconds:.2f}", utterances=rep["utterances"],
              wer=rep.get("wer"), uer=rep.get("uer"), hypo_lines=len(hyps),
              launches_l1_conv_attn_fwd_bwd=counts)
        if not {"utterances", "wer", "uer"} <= set(rep) or rep["utterances"] != len(sizes) \
                or len(hyps) != len(sizes):
            fail(f"ctc_pipeline: decode {name}: report {rep}, {len(hyps)} hypothesis lines")
        if not (counts[0] and counts[2] and counts[4]) or counts[1] or counts[3] or counts[5]:
            fail(f"ctc_pipeline: decode {name}: launches {counts}")
        reports[name] = rep
    return reports



S2S_FREEZE, S2S_STEPS, S2S_DECODE_LEN, S2S_BEAM = 2, 5, 64, 5


def seq2seq_large_config(freeze: int, **enc_over):
    """The Seq2SeqModel finetune-seq2seq --arch large builds: WavLM-Large's
    encoder with the gated relative position bias (dropout 0.1, attention
    dropout 0.1, remat_layers), time mask 0.5/10, channel mask 0.5/64, the
    default decoder (768 wide, 3072 FFN, 6 layers, 4 heads, so enc_proj),
    the letter dictionary."""
    from unispeech_tpu_torch.configs import MaskConfig, large_encoder_config
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.seq2seq import Seq2SeqConfig, Seq2SeqDecoderConfig

    d = Dictionary.letters()
    enc = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True, **enc_over)
    return Seq2SeqConfig(encoder=enc, decoder=Seq2SeqDecoderConfig(vocab_size=len(d),
                                                                   padding_idx=d.pad()),
                         apply_mask=True, time_mask=MaskConfig(mask_prob=0.5, mask_length=10),
                         freeze_finetune_updates=freeze)


def seq2seq_batch(d, wav, lengths, rng):
    """The smoke batch with random letter transcripts (15 symbols per
    second), in Seq2SeqIterator's form: eos-shifted prev_tokens,
    eos-terminated targets, target_mask, S a multiple of 8."""
    B = wav.shape[0]
    enc = [d.encode_line(letter_transcript(rng, float(n) / SAMPLE_RATE)) for n in lengths.cpu()]
    S = int(np.ceil((max(len(e) for e in enc) + 1) / 8) * 8)
    tgt = np.full((B, S), d.pad(), np.int32)
    prev = np.full((B, S), d.pad(), np.int32)
    mask = np.zeros((B, S), np.float32)
    for r, e in enumerate(enc):
        L = len(e)
        tgt[r, :L], tgt[r, L] = e, d.eos()
        prev[r, 0], prev[r, 1:L + 1] = d.eos(), e
        mask[r, :L + 1] = 1.0
    dev = wav.device
    return {"source": wav, "lengths": lengths.to(torch.int32),
            "prev_tokens": torch.from_numpy(prev).to(dev),
            "targets": torch.from_numpy(tgt).to(dev),
            "target_mask": torch.from_numpy(mask).to(dev)}


def s2s_train_phase(dev, counters, s2s_counts, wav, lengths):
    """s2s_train: seq2seq fine-tuning at WavLM-Large's width on the smoke
    batch, the backbone grafted from a seed-0 HubertPretrainModel at the
    bench's Large config: 5 steps, the first 2 frozen, with launch counts
    per step; one unfrozen step's gradients, kernel path against plain path;
    20 unfrozen steps on one batch, the loss must fall; a batch with a
    zero-length row, finite; greedy and beam decoding (K = 5, no-repeat-
    ngram 3, max_len 64) with beam K = 1 equal to greedy and the beams
    sorted and distinct; then a GLU + iPQ-noise encoder at full width."""
    from unispeech_tpu_torch.configs import (
        HubertPretrainConfig,
        MaskConfig,
        large_encoder_config,
    )
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.ctc import load_pretrained_into
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.models.seq2seq import Seq2SeqModel, beam_decode, greedy_decode
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_seq2seq_loss_fn

    d = Dictionary.letters()
    cfg = seq2seq_large_config(S2S_FREEZE)
    model = Seq2SeqModel(cfg, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(SEED + 21))
    penc = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                                encoder_layerdrop=0.05, remat_layers=False, scan_layers=False)
    pre = HubertPretrainModel(HubertPretrainConfig(
        encoder=penc, time_mask=MaskConfig(mask_prob=0.8, mask_length=10),
        num_classes=(N_CLASSES,), final_dim=768), generator=torch.Generator().manual_seed(SEED))
    load_pretrained_into(model, pre.state_dict())
    backbone = dict(pre.state_dict())
    if any(not torch.equal(v, backbone[k]) for k, v in model.wavlm.state_dict().items()):
        fail("s2s_train: the graft did not carry the pretrained backbone")
    del pre, backbone
    nparams = sum(p.numel() for p in model.parameters())
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    batch = seq2seq_batch(d, wav, lengths, np.random.default_rng(SEED + 22))
    phase("s2s_train", params=nparams, decoder_params=n_dec,
          enc_proj=tuple(model.enc_proj.weight.shape), S=batch["targets"].shape[1],
          targets=int(batch["target_mask"].sum()))
    state = create_train_state(model, OptimConfig(lr=5e-5, warmup_steps=2, total_steps=100,
                                                  schedule="tri_stage", hold_steps=40),
                               device=dev)
    step = make_train_step(make_seq2seq_loss_fn(model))
    gen = torch.Generator().manual_seed(SEED + 23)
    L = cfg.encoder.encoder_layers

    def reset():
        for m, attr in counters:
            setattr(m, attr, 0)

    for i in range(S2S_STEPS):
        reset()
        frozen = model.frozen(state.step)
        met = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = tuple(getattr(m, attr) for m, attr in counters)
        kept = L - met["layers_dropped"]
        # as ctc_train: no L1 or conv backward (feature_grad_mult 0), the
        # attention backward only once unfrozen (remat_layers: 2 forwards)
        want = (1, 0, 12, 0) + ((kept, 0) if frozen else (2 * kept, 2 * kept))
        loss, gnorm = float(met["loss_per_sample"]), float(met["grad_norm"])
        phase("s2s_train", step=i, frozen=frozen, loss_per_token=f"{loss:.4f}",
              grad_norm=f"{gnorm:.4f}", ntokens=int(met["sample_size"]),
              layers_dropped=met["layers_dropped"], launches_l1_conv_attn_fwd_bwd=counts)
        if counts != want:
            fail(f"s2s_train step {i}: launches {counts} != {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"s2s_train step {i}: loss {loss}, grad_norm {gnorm}")
        s2s_counts.setdefault("frozen" if frozen else "unfrozen", counts)

    # one unfrozen step's gradients, kernel path against plain path (the
    # eval loss: no masks, no dropout)
    loss_eval = make_seq2seq_loss_fn(model, deterministic=True)

    def grads():
        model.zero_grad(set_to_none=True)
        loss, ss, _ = loss_eval(batch, None, S2S_FREEZE)
        (loss / torch.clamp(ss, min=1.0)).backward()
        return [torch.zeros_like(p) if p.grad is None else p.grad.float().clone()
                for p in model.parameters()]

    gk = grads()
    with plain_ops():
        gp = grads()
    total = float(torch.sqrt(sum((g * g).sum() for g in gp)))
    worst = []
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        diff, ref = float((a - b).norm()), float(b.norm())
        worst.append((diff / (GRAD_TOL * ref + GRAD_FLOOR * total), name, diff / max(ref, 1e-30)))
    worst.sort(reverse=True)
    for ratio, name, rel in worst[:5]:
        phase("s2s_train", grad_vs_plain=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{ratio:.3g}")
    phase("s2s_train", grad_tol=f"{GRAD_TOL} * |g| + {GRAD_FLOOR} * |global|",
          global_grad_norm=f"{total:.4g}", tensors=len(worst))
    if worst[0][0] > 1.0:
        fail(f"s2s_train: gradient of {worst[0][1]}: kernel path disagrees with the plain path")
    del gk, gp
    model.zero_grad(set_to_none=True)

    # a zero-length padding row (target_mask 0, as Seq2SeqIterator gives
    # it): the loss, the logits of that row and the gradients are finite
    crafted = {k: v.clone() for k, v in batch.items()}
    crafted["source"][2] = 0.0
    crafted["lengths"][2] = 0
    crafted["prev_tokens"][2] = d.pad()
    crafted["prev_tokens"][2, 0] = d.eos()
    crafted["targets"][2] = d.pad()
    crafted["targets"][2, 0] = d.eos()
    crafted["target_mask"][2] = 0.0
    out = model(crafted["source"], crafted["prev_tokens"], crafted["lengths"],
                deterministic=True, step=S2S_FREEZE)
    row_finite = bool(torch.isfinite(out.logits[2]).all())
    del out
    met = step(state, crafted, gen)
    g_finite = all(p.grad is None or bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    phase("s2s_train", zero_row_loss=f"{float(met['loss_per_sample']):.4f}",
          zero_row_logits_finite=row_finite, grads_finite=g_finite,
          ntokens=int(met["sample_size"]))
    if not (row_finite and g_finite and np.isfinite(float(met["loss_per_sample"]))
            and int(met["sample_size"]) == int(crafted["target_mask"].sum())):
        fail("s2s_train: the batch with a zero-length row is not finite")

    # ms per step (back to back), host enqueue, peak memory, one profiled
    # unfrozen step
    def timed(frozen, n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state.step = 0 if frozen else S2S_FREEZE
            step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        state.step = 0 if frozen else S2S_FREEZE
        t0 = time.perf_counter()
        step(state, batch, gen)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms, host

    frozen_ms, host_frozen = timed(True)
    torch.cuda.reset_peak_memory_stats()
    unfrozen_ms, host_unfrozen = timed(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state.step = S2S_FREEZE
    prof = profile_once(lambda: step(state, batch, gen), "s2s_unfrozen_profile")

    # decoding: greedy and beam at max_len 64; K = 1 without the ban is
    # greedy; the beams come sorted and distinct
    model.eval()
    eos = d.eos()
    src, lens = batch["source"], batch["lengths"]

    def decode_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    reset()
    greedy, greedy_ms = decode_ms(lambda: greedy_decode(model, src, lens, eos, eos,
                                                        max_len=S2S_DECODE_LEN))
    dec_counts = tuple(getattr(m, attr) for m, attr in counters)
    (beam1, _), beam1_ms = decode_ms(lambda: beam_decode(model, src, lens, eos, eos,
                                                         beam_size=1, max_len=S2S_DECODE_LEN))
    (beams, scores), beam_ms = decode_ms(lambda: beam_decode(
        model, src, lens, eos, eos, beam_size=S2S_BEAM, max_len=S2S_DECODE_LEN,
        no_repeat_ngram=3))
    distinct = all(len({tuple(beams[b, k].tolist()) for k in range(S2S_BEAM)}) == S2S_BEAM
                   for b in range(beams.shape[0]))
    ordered = bool((scores[:, :-1] >= scores[:, 1:]).all())
    hyps = [d.string([t for t in row.tolist() if t != eos][:12]) for row in greedy]
    phase("s2s_train", greedy_ms=f"{greedy_ms:.1f}", beam1_ms=f"{beam1_ms:.1f}",
          beam5_ms=f"{beam_ms:.1f}", decode_len=S2S_DECODE_LEN,
          decode_launches_l1_conv_attn_fwd_bwd=dec_counts,
          beam1_equals_greedy=bool(torch.equal(beam1[:, 0], greedy)),
          beams_sorted=ordered, beams_distinct=distinct,
          best_scores=[f"{x:.3f}" for x in scores[:, 0].tolist()], greedy_head=hyps)
    if not torch.equal(beam1[:, 0], greedy):
        fail("s2s_train: beam search with K = 1 does not give greedy's tokens")
    if not (ordered and distinct and torch.isfinite(scores).all()):
        fail("s2s_train: the beams are not sorted, distinct and finite")
    if dec_counts != (1, 0, 12, 0, 24, 0):
        fail(f"s2s_train: a decode's encoder launches {dec_counts}")

    # learning: 20 unfrozen steps on one batch at a fixed learning rate
    model.train()
    state = create_train_state(model, OptimConfig(lr=1e-4, schedule="fixed"), device=dev)
    state.step = S2S_FREEZE
    losses = [float(step(state, batch, gen)["loss_per_sample"]) for _ in range(20)]
    phase("s2s_train", learning_first=f"{losses[0]:.4f}", learning_last=f"{losses[-1]:.4f}",
          steps=len(losses), losses=",".join(f"{x:.3f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"s2s_train: 20 steps on one batch: loss {losses[0]} -> {losses[-1]} did not fall")
    del state, model, step
    torch.cuda.empty_cache()
    glu_quant_noise(dev, batch)
    audio_s = float(lengths.sum()) / SAMPLE_RATE
    return dict(params=nparams, frozen_ms=frozen_ms, unfrozen_ms=unfrozen_ms,
                host_frozen_ms=host_frozen, host_unfrozen_ms=host_unfrozen, peak_gb=peak_gb,
                audio_s=audio_s, profile=prof, greedy_ms=greedy_ms, beam_ms=beam_ms,
                beam1_ms=beam1_ms)


GLU_QN_LAYERS = 4


def glu_quant_noise(dev, batch):
    """The GLU feed-forward with iPQ noise (quant_noise_pq 0.1) in a
    WavLM-Large-width encoder cut to 4 layers, under the default decoder:
    the forward, kernel path against plain path (relative L2 5e-2, as the
    serving paths), with and without the noise (the same seeds, so the
    same block masks); 3 train steps with finite losses; the share of
    dropped blocks within 4 sigma of p."""
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.seq2seq import Seq2SeqModel
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_seq2seq_loss_fn

    p = 0.1
    cfg = seq2seq_large_config(0, encoder_layers=GLU_QN_LAYERS, activation_fn="glu",
                               quant_noise_pq=p, dropout=0.0, attention_dropout=0.0,
                               activation_dropout=0.0, encoder_layerdrop=0.0)
    model = Seq2SeqModel(cfg, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(SEED + 24)).to(dev)
    if model.wavlm.encoder.layers[0].fc1.linear.weight.shape != (2 * 4096, 1024):
        fail("glu: fc1 is not the GLU's Linear(1024, 2 * 4096)")
    drawn = {}  # seed -> (dropped, blocks); remat_layers draws each mask twice
    real = encoder.quant_noise_blocks

    def counted(seed, *args):
        out = real(seed, *args)
        drawn[seed] = (int(out.sum()), out.numel())
        return out

    src, lens = batch["source"], batch["lengths"]
    rel = {}
    with torch.no_grad():
        for name, det in (("serving", True), ("qn_training", False)):
            run = lambda: model.encode(src, lens, deterministic=det,
                                       generator=torch.Generator().manual_seed(SEED + 25))[0]
            got = run()
            with plain_ops():
                want = run()
            rel[name] = rel_l2(got, want)
    phase("glu_qn", layers=GLU_QN_LAYERS, rel_l2_vs_plain=rel, tol="5e-2")
    if not all(np.isfinite(v) and v <= 5e-2 for v in rel.values()):
        fail(f"glu_qn: kernel path disagrees with the plain path: {rel}")
    state = create_train_state(model, OptimConfig(lr=5e-5, schedule="fixed"), device=dev)
    step = make_train_step(make_seq2seq_loss_fn(model))
    gen = torch.Generator().manual_seed(SEED + 26)
    encoder.quant_noise_blocks = counted
    try:
        losses = [float(step(state, batch, gen)["loss_per_sample"]) for _ in range(3)]
    finally:
        encoder.quant_noise_blocks = real
    n_blocks = sum(b for _, b in drawn.values())
    share = sum(k for k, _ in drawn.values()) / max(n_blocks, 1)
    sigma = math.sqrt(p * (1 - p) / max(n_blocks, 1))
    phase("glu_qn", losses=",".join(f"{x:.3f}" for x in losses), dropped_share=f"{share:.5f}",
          blocks=n_blocks, masks=len(drawn), p=p, four_sigma=f"{4 * sigma:.5f}")
    if not all(np.isfinite(losses)):
        fail(f"glu_qn: a train step is not finite: {losses}")
    if not abs(share - p) <= 4 * sigma:
        fail(f"glu_qn: dropped share {share} is not within 4 sigma of {p}")
    del state, model
    torch.cuda.empty_cache()


LM_VOCAB, LM_TOKENS = 10_000, 160_000


def lm_train_phase(dev):
    """lm_train: the TransformerLM train-lm builds at its defaults (512
    wide, 2048 FFN, 6 layers, 8 heads, dropout 0.1; block 128, batch 32),
    bf16, on a synthetic Zipf corpus of 10,000 words from the seed through
    TokenBlockDataset and LMIterator: 20 steps, the loss must fall; step ms
    and tokens per second; the NeuralLMScorer's log-probs on the card
    against the same fp32 weights on the CPU (TF32 off), rtol 1e-4."""
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.lm_dataset import LMIterator, TokenBlockDataset
    from unispeech_tpu_torch.decode.lm_fusion import NeuralLMScorer
    from unispeech_tpu_torch.models.lm import TransformerLM, TransformerLMConfig
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_lm_loss_fn

    words = Dictionary()
    for i in range(LM_VOCAB):
        words.add_symbol(f"w{i}")
    rng = np.random.default_rng(SEED + 31)
    ranks = np.minimum(rng.zipf(1.2, LM_TOKENS), LM_VOCAB) - 1
    tokens = (ranks + words.nspecial).astype(np.int32)
    tokens[rng.random(LM_TOKENS) < 0.08] = words.eos()  # sentence ends
    cfg = TransformerLMConfig(vocab_size=len(words), padding_idx=words.pad(),
                              max_positions=2048)
    model = TransformerLM(cfg, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED + 32))
    nparams = sum(p.numel() for p in model.parameters())
    data = iter(LMIterator(TokenBlockDataset(tokens, 128), batch_size=32,
                           padding_idx=words.pad(), seed=SEED))
    state = create_train_state(model, OptimConfig(lr=5e-4, schedule="fixed"), device=dev)
    step = make_train_step(make_lm_loss_fn(model, words.pad()))
    gen = torch.Generator().manual_seed(SEED + 33)
    to_dev = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    losses = []
    for _ in range(20):
        losses.append(float(step(state, to_dev(next(data)), gen)["loss_per_sample"]))
    phase("lm_train", params=nparams, learning_first=f"{losses[0]:.4f}",
          learning_last=f"{losses[-1]:.4f}", losses=",".join(f"{x:.3f}" for x in losses))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"lm_train: 20 steps: loss {losses[0]} -> {losses[-1]} did not fall")
    batch = to_dev(next(data))
    step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    n_tok = int(batch["tokens"].numel())
    phase("lm_train", step_ms=f"{step_ms:.3f}", tokens_per_step=n_tok,
          tokens_per_s=f"{n_tok / (step_ms / 1e3):.0f}")

    # the scorer on the card against the CPU, fp32, the same weights
    fp32 = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    scorers = []
    for device in (dev, "cpu"):
        m = TransformerLM(cfg)
        m.load_state_dict(fp32)
        scorers.append(NeuralLMScorer(m.to(device), words, window=128))
    worst = 0.0
    state_ = scorers[0].start()
    for w in rng.integers(words.nspecial, len(words), 12):
        a, b = (s._next_logprobs(state_) for s in scorers)
        worst = max(worst, float(np.max(np.abs(a - b) / (np.abs(b) + 1e-30))))
        if not np.allclose(a, b, rtol=1e-4, atol=0):
            fail(f"lm_train: the scorer on the card disagrees with the CPU at {state_}")
        state_, _ = scorers[0].score(state_, words[int(w)])
    phase("lm_train", scorer_max_rel_err=f"{worst:.3g}", tol="rtol 1e-4", states=12)
    del state, model, scorers
    torch.cuda.empty_cache()
    return dict(params=nparams, step_ms=step_ms, tokens_per_step=n_tok)


def s2s_pipeline_phase(counters, tmp):
    """s2s_pipeline: through the CLIs' main(argv) in-process, on the
    pipeline phase's 12 wav files: finetune-seq2seq --arch large --w2v-path
    <the pipeline's export> (valid WER, --best-metric wer, freeze 2,
    --valid-decode-max-len 32) to update 2, resumed to 4; data binarize-text
    on a word corpus, train-lm from the .bin for 10 updates with
    --export-params; decode --decoder seq2seq of the seq2seq export; decode
    --decoder neural of ctc_pipeline's export with a lexicon and the LM.
    Returns the decodes' seconds."""
    import io

    from unispeech_tpu_torch.data.__main__ import main as data_main
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.decode.__main__ import main as decode_main
    from unispeech_tpu_torch.train.__main__ import main as train_main

    man = str(tmp / "man" / "train.tsv")
    ltr = tmp / "train.ltr"
    n_files = len(pathlib.Path(man).read_text().splitlines()) - 1
    ckpt = str(tmp / "s2s_ckpt")

    def reset():
        for m, attr in counters:
            setattr(m, attr, 0)

    def run(main, argv, what):
        reset()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log), contextlib.redirect_stdout(io.StringIO()):
            main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tuple(getattr(m, attr) for m, attr in counters)
        lines = log.getvalue().splitlines()
        train = [json.loads(x) for x in lines if x.startswith('{"tag": "train"')]
        valid = [json.loads(x) for x in lines if x.startswith('{"tag": "valid"')]
        for r in train:
            phase("s2s_pipeline", update=r["step"], wall_s=r["elapsed_s"], loss=r["loss_avg"])
        for r in valid:
            phase("s2s_pipeline", valid_update=r["step"], loss=r["loss_avg"], wer=r.get("wer"),
                  uer=r.get("uer"))
        phase("s2s_pipeline", step=what, seconds=f"{seconds:.2f}",
              launches_l1_conv_attn_fwd_bwd=counts)
        if not all(np.isfinite(r["loss_avg"]) for r in train + valid):
            fail(f"s2s_pipeline: {what}: a non-finite loss")
        return train, valid, counts, seconds

    def finetune(max_updates, out):
        argv = ["finetune-seq2seq", "--manifest", man, "--transcripts", str(ltr),
                "--valid-manifest", man, "--valid-transcripts", str(ltr), "--arch", "large",
                "--w2v-path", str(tmp / "export.npz"), "--best-metric", "wer",
                "--freeze-finetune-updates", str(S2S_FREEZE), "--valid-decode-max-len", "32",
                "--save-interval-updates", "2", "--log-interval", "1", "--lr", "5e-5",
                "--warmup-steps", "2", "--max-updates", str(max_updates),
                "--checkpoint-dir", ckpt, "--export-params", str(tmp / out)]
        train, valid, counts, _ = run(train_main, argv,
                                      f"finetune-seq2seq --max-updates {max_updates}")
        if [r["step"] for r in valid] != [max_updates] or \
                not all("wer" in r and np.isfinite(r["wer"]) for r in valid):
            fail(f"s2s_pipeline: no valid WER at each validation: {valid}")
        if counts[1] or counts[3] or not (counts[0] and counts[2] and counts[4]):
            fail(f"s2s_pipeline: finetune launches {counts}")
        return [r["step"] for r in train], counts

    first, c_first = finetune(2, "s2s2.npz")
    second, c_second = finetune(4, "s2s4.npz")
    phase("s2s_pipeline", first_run_updates=first, resumed_run_updates=second)
    if first != [1, 2] or second != [3, 4]:
        fail(f"s2s_pipeline: the resumed run did not start at update 2: {first}, {second}")
    if c_first[5] != 0 or c_second[5] == 0:
        fail(f"s2s_pipeline: attention backward launches {c_first[5]}, {c_second[5]}")
    shutil.rmtree(ckpt, ignore_errors=True)

    # a word corpus over the transcripts' words, binarized, and an LM on it
    texts = ltr.read_text().splitlines()
    vocab = sorted({w.replace(" ", "") for t in texts for w in t.split("|") if w.strip()})
    words = Dictionary()
    for w in vocab:
        words.add_symbol(w)
    words.save(str(tmp / "words.txt"))
    rng = np.random.default_rng(SEED + 34)
    lines = [" ".join(rng.choice(vocab, int(rng.integers(4, 13)))) for _ in range(700)]
    (tmp / "words_corpus.txt").write_text("\n".join(lines) + "\n")
    run(data_main, ["binarize-text", "--corpus", str(tmp / "words_corpus.txt"), "--dict",
                    str(tmp / "words.txt"), "--out", str(tmp / "lm_bin" / "corpus")],
        "binarize-text")
    train, _, _, _ = run(train_main, [
        "train-lm", "--corpus", str(tmp / "lm_bin" / "corpus.bin"), "--dict",
        str(tmp / "words.txt"), "--max-updates", "10", "--warmup-steps", "2",
        "--log-interval", "1", "--save-interval-updates", "10", "--checkpoint-dir",
        str(tmp / "lm_ckpt"), "--export-params", str(tmp / "lm.npz")], "train-lm")
    if [r["step"] for r in train] != list(range(1, 11)) or \
            not (tmp / "lm.json").exists() or not (tmp / "lm_ckpt" / "lm_config.json").exists():
        fail("s2s_pipeline: train-lm did not run 10 updates and write its configs")

    seconds = {}
    for name, extra in (("seq2seq", ["--checkpoint", str(tmp / "s2s4.npz"), "--decoder",
                                     "seq2seq", "--seq2seq-beam", "5", "--max-decode-len",
                                     "32", "--no-repeat-ngram", "3"]),
                        ("neural", ["--checkpoint", str(tmp / "ctc4.npz"), "--decoder",
                                    "neural", "--lexicon", str(tmp / "lexicon.txt"),
                                    "--lm-model", str(tmp / "lm.npz"), "--lm-dict",
                                    str(tmp / "words.txt"), "--beam", "8"])):
        out = tmp / f"decode_{name}"
        _, _, counts, secs = run(decode_main, ["--manifest", man, "--transcripts", str(ltr),
                                               "--arch", "large", "--results-path", str(out),
                                               *extra], f"decode --decoder {name}")
        rep = json.loads((out / "wer_report.json").read_text())
        hyps = (out / "hypo.word").read_text().splitlines()
        phase("s2s_pipeline", decode=name, seconds=f"{secs:.2f}", utterances=rep["utterances"],
              wer=rep.get("wer"), uer=rep.get("uer"), hypo_lines=len(hyps),
              seconds_per_file=f"{secs / max(len(hyps), 1):.3f}")
        if not {"utterances", "wer", "uer"} <= set(rep) or rep["utterances"] != n_files \
                or len(hyps) != n_files:
            fail(f"s2s_pipeline: decode {name}: report {rep}, {len(hyps)} hypothesis lines")
        if not (counts[0] and counts[2] and counts[4]) or counts[1] or counts[3] or counts[5]:
            fail(f"s2s_pipeline: decode {name}: launches {counts}")
        seconds[name] = secs
    return seconds


def unispeech_large_config():
    """The UniSpeech model of w2v_train: WavLM-Large's encoder as
    pretrain-wav2vec2 --arch large builds it (24 layers, width 1024, 16
    heads, layer_norm extractor, pre-LN, no relative position bias, dropout
    0.1, remat_layers), the reference's wav2vec 2.0 Large heads (final_dim
    768, vq_dim = final_dim 768: fairseq's wav2vec2_large_librivox has
    latent_dim 0), Gumbel 2 groups x 320, 100 negatives, transpose mode, the
    letter CTC head with replace_prob 0.5."""
    from unispeech_tpu_torch.configs import (
        GumbelVQConfig,
        MaskConfig,
        Wav2Vec2PretrainConfig,
        large_encoder_config,
    )

    return Wav2Vec2PretrainConfig(
        encoder=large_encoder_config(), time_mask=MaskConfig(mask_prob=0.65, mask_length=10),
        final_dim=768, quantizer=GumbelVQConfig(num_vars=320, groups=2, vq_dim=768),
        num_negatives=100, transpose=True, ctc_vocab_size=len(LETTERS) + 4, replace_prob=0.5)


def sat_large_config():
    """The UniSpeech-SAT model of sat_train: the bench's Large pretraining
    config (bench.py:154-206: rel-pos bias with the gate, dropout 0.1,
    layerdrop 0.05, final_dim 768, 504 classes) with the speaker branch as
    pretrain-hubert --sat sets it (one same-utterance and 100 cross-sample
    instances, the tap at layer 6)."""
    from unispeech_tpu_torch.configs import HubertPretrainConfig, MaskConfig, large_encoder_config

    enc = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                               encoder_layerdrop=0.05, dropout=0.1, attention_dropout=0.1,
                               remat_ffn=True, remat_layers=False, scan_layers=False)
    return HubertPretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.8, mask_length=10),
                                num_classes=(N_CLASSES,), final_dim=768,
                                utterance_contrastive_loss=True, num_instances=1,
                                cross_sample_instances=100)


@contextlib.contextmanager
def pinned_codewords(picks, flips):
    """The Gumbel quantizer's hard choices, call by call: recorded into
    ``picks`` when it is empty on entry, else taken from it (the soft
    probabilities stay the run's own), counting in ``flips`` the choices
    the run would have made otherwise. Two paths round the quantizer's
    input differently, and a near-tie of the noisy logits then picks
    another codeword, which changes that frame's target: pinned, the runs
    differ only in their arithmetic."""
    from unispeech_tpu_torch.ops import quantizer

    real = quantizer.gumbel_softmax
    replay = bool(picks)
    calls = iter(range(1 << 30))

    def fn(logits, tau, noise, hard=True):
        y = real(logits, tau, noise, hard)
        i = next(calls)
        if not replay:
            picks.append(y.detach().argmax(-1))
            return y
        y_soft = torch.softmax((logits.float() + noise) / tau, dim=-1)
        flips.append(int((y_soft.argmax(-1) != picks[i]).sum()))
        y_hard = F.one_hot(picks[i], logits.shape[-1]).to(y_soft.dtype)
        return y_hard + y_soft - y_soft.detach()

    quantizer.gumbel_softmax = fn
    try:
        yield
    finally:
        quantizer.gumbel_softmax = real


def contrastive_train_phase(dev, counters, tag, wav, lengths, counts_out):
    """w2v_train (UniSpeech at Large width: InfoNCE + 0.5 phonetic CTC) or
    sat_train (UniSpeech-SAT at Large width) on the padded smoke batch
    (random letter transcripts at 15 symbols per second, or random frame
    labels): 3 steps with launch counts per step; one step's gradients for
    each of GRAD_DRAWS generator seeds, kernel path against plain path with
    the same seed (the same masks, dropout, negatives or instances, Gumbel
    noise, replace mask; the quantizer's codeword choices pinned), stacked
    over the draws; 20 steps on one batch, the loss must fall. Fills ``counts_out`` with the first step's launch counts;
    returns the end-to-end numbers."""
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn, make_wav2vec2_loss_fn

    w2v = tag == "w2v_train"
    B = wav.shape[0]
    gen = torch.Generator().manual_seed(SEED + (21 if w2v else 22))
    batch = {"source": wav, "lengths": lengths.to(torch.int32)}
    if w2v:
        cfg = unispeech_large_config()
        model = Wav2Vec2PretrainModel(cfg, dtype=torch.bfloat16,
                                      generator=torch.Generator().manual_seed(SEED))
        d = Dictionary.letters()
        rng = np.random.default_rng(SEED + 23)
        enc_texts = [d.encode_line(letter_transcript(rng, float(n) / SAMPLE_RATE))
                     for n in lengths.cpu()]
        S = int(np.ceil(max(len(e) for e in enc_texts) / 8) * 8)
        labels = np.full((B, S), d.pad(), np.int32)
        for r, e in enumerate(enc_texts):
            labels[r, :len(e)] = e
        batch["labels"] = torch.from_numpy(labels).to(dev)
        batch["label_lengths"] = torch.tensor([len(e) for e in enc_texts], dtype=torch.int32,
                                              device=dev)
        loss_fn = make_wav2vec2_loss_fn(model, mtlalpha=0.5)
        enc = cfg.encoder
    else:
        cfg = sat_large_config()
        model = HubertPretrainModel(cfg, dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(SEED))
        enc = cfg.encoder
        T = enc.num_frames(wav.shape[1])
        batch["targets"] = torch.randint(0, N_CLASSES, (B, T, 1), generator=gen).to(dev)
        loss_fn = make_hubert_loss_fn(model, HubertCriterionConfig(spk_loss_weight=0.1))
    nparams = sum(p.numel() for p in model.parameters())
    state = create_train_state(model, OptimConfig(lr=5e-4, warmup_steps=100, total_steps=1000),
                               device=dev)
    step = make_train_step(loss_fn)
    L = enc.encoder_layers
    phase(tag, params=nparams, frames=enc.num_frames(wav.shape[1]), batch=B)

    def reset():
        for m, attr in counters:
            setattr(m, attr, 0)

    for i in range(3):
        reset()
        met = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = tuple(getattr(m, attr) for m, attr in counters)
        kept = L - met["layers_dropped"]
        # L1 without the sums and its backward; each block's H pass and GEMM
        # forward, H, dx, dW backward (the frontend trains: feature_grad_mult
        # 1.0, on padded rows); attention forward once per kept layer, twice
        # with remat_layers (w2v), its pre-pass and kernel backward
        want = (1, 1, 12, 18) + ((2 * kept, 2 * kept) if w2v else (kept, 2 * kept))
        loss, gnorm = float(met["loss_per_sample"]), float(met["grad_norm"])
        extra = (dict(loss_ctc=f"{float(met['loss_ctc']):.3f}",
                      loss_contrastive=f"{float(met['loss_contrastive']):.3f}",
                      temp=f"{cfg.quantizer.temp_at(i):.6f}",
                      code_perplexity=f"{float(met['code_perplexity']):.2f}",
                      prob_perplexity=f"{float(met['prob_perplexity']):.2f}") if w2v else
                 dict(loss_spk_m=f"{float(met['loss_spk_m']):.4f}",
                      contrastive_acc=f"{float(met['contrastive_acc']):.4f}"))
        phase(tag, step=i, loss_per_sample=f"{loss:.4f}", grad_norm=f"{gnorm:.4f}",
              sample_size=int(met["sample_size"]), layers_dropped=met["layers_dropped"],
              launches_l1_conv_attn_fwd_bwd=counts, **extra)
        if counts != want:
            fail(f"{tag} step {i}: launches {counts} != {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"{tag} step {i}: loss {loss}, grad_norm {gnorm}")
        if i == 0:
            counts_out.update(zip(("l1", "l1_bwd", "conv", "conv_bwd", "attn", "attn_bwd"),
                                  counts))

    # one step's gradients, kernel path against plain path, for GRAD_DRAWS
    # draws of the step's randomness (masks, dropout, negatives or
    # instances, Gumbel noise, replace mask): the same weights and generator
    # seed on both paths, the codeword choices pinned. At random weights the
    # contrastive gradient is a difference of near-equal terms, and bf16
    # rounding moves it by 10-20% in either path. The frontend's gradient is
    # led by the last valid frame of each padded row: its receptive field
    # reaches the padding, whose LayerNorms see (near) zero variance and
    # scale the gradient by up to 1/sqrt(eps), bf16 noise with it, on both
    # paths. So a
    # tensor that misses train's rule passes when the kernel path is no
    # further from the same steps in fp32 (the plain ops) than the bf16
    # plain path is, 1.5x. Both rules read each tensor's gradients of all
    # draws stacked
    def grads(m, seed):
        m.zero_grad(set_to_none=True)
        fn = (make_wav2vec2_loss_fn(m, mtlalpha=0.5) if w2v else
              make_hubert_loss_fn(m, HubertCriterionConfig(spk_loss_weight=0.1)))
        loss, ss, _ = fn(batch, torch.Generator().manual_seed(seed), state.step)
        (loss / torch.clamp(ss, min=1.0)).backward()
        out = [torch.zeros_like(p) if p.grad is None else p.grad.float().clone()
               for p in m.parameters()]
        m.zero_grad(set_to_none=True)
        return out

    model32 = type(model)(cfg).to(dev)
    model32.load_state_dict(model.state_dict())
    # per draw and tensor: |gk - gp|^2, |gp|^2, |gk - g32|^2, |gp - g32|^2
    per_draw = []
    n_pinned = n_flips = 0
    for d in range(GRAD_DRAWS):
        picks, flips = [], []
        seed = SEED + 24 + d
        with pinned_codewords(picks, flips):
            gk = grads(model, seed)
        with pinned_codewords(picks, flips), plain_ops():
            gp = grads(model, seed)
        with pinned_codewords(picks, flips), plain_ops():
            g32 = grads(model32, seed)
        per_draw.append(torch.stack([
            torch.stack([((a - b) ** 2).sum(), (b * b).sum(), ((a - c) ** 2).sum(),
                         ((b - c) ** 2).sum()])
            for a, b, c in zip(gk, gp, g32)], 1).double().cpu())
        n_pinned += sum(int(p.numel()) for p in picks)
        n_flips += sum(flips)
        del gk, gp, g32
    del model32
    diff, ref, err_k, err_p = sum(per_draw).sqrt().tolist()
    total = math.sqrt(sum(r * r for r in ref))
    worst = []
    for j, (name, _) in enumerate(model.named_parameters()):
        rule = diff[j] / (GRAD_TOL * ref[j] + GRAD_FLOOR * total)
        vs32 = err_k[j] / (1.5 * err_p[j] + GRAD_FLOOR * total)
        worst.append((min(rule, vs32), rule, name, diff[j] / max(ref[j], 1e-30), err_k[j],
                      err_p[j], j))
    worst.sort(reverse=True)
    for ratio, rule, name, rel, ek, ep, _ in worst[:5]:
        phase(tag, grad_vs_plain=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{rule:.3g}",
              kernel_vs_fp32=f"{ek:.3g}", plain_vs_fp32=f"{ep:.3g}",
              of_fp32_tolerance=f"{ratio:.3g}")
    phase(tag, grad_tol=f"{GRAD_TOL} * |g| + {GRAD_FLOOR} * |global|",
          or_fp32_tol=f"|gk - g32| <= 1.5 |gp - g32| + {GRAD_FLOOR} * |global|",
          draws_stacked=GRAD_DRAWS, global_grad_norm=f"{total:.4g}", tensors=len(worst),
          within_train_rule=sum(1 for w in worst if w[1] <= 1.0),
          codeword_choices_pinned=n_pinned, plain_path_would_differ=n_flips)
    j = worst[0][-1]
    phase(tag, worst_tensor_per_draw=worst[0][2], kernel_over_plain_fp32_error=",".join(
        f"{math.sqrt(e[2, j] / max(e[3, j], 1e-60)):.3f}" for e in per_draw))
    if worst[0][0] > 1.0:
        fail(f"{tag}: gradient of {worst[0][2]}: kernel path disagrees with the plain path")

    # ms per step (back to back), host enqueue on an idle queue, peak memory,
    # one profiled step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_time = 3
    t0 = time.perf_counter()
    for _ in range(n_time):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_time
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    step(state, batch, gen)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    busy_ms, wall_ms, n_launch = profile_once(lambda: step(state, batch, gen), f"{tag}_profile")

    # learning: 20 steps on one batch at a fixed learning rate
    state = create_train_state(model, OptimConfig(lr=5e-4, schedule="fixed"), device=dev)
    losses = [float(step(state, batch, gen)["loss_per_sample"]) for _ in range(20)]
    phase(tag, learning_first=f"{losses[0]:.4f}", learning_last=f"{losses[-1]:.4f}",
          steps=len(losses), losses=",".join(f"{x:.3f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"{tag}: 20 steps on one batch: loss {losses[0]} -> {losses[-1]} did not fall")
    audio_s = float(lengths.sum()) / SAMPLE_RATE
    return dict(params=nparams, step_ms=step_ms, host_ms=host_ms, peak_gb=peak_gb,
                audio_s=audio_s, busy_ms=busy_ms, wall_ms=wall_ms, launches=n_launch)


def nobias_attention_rows(dev, lengths, w2v_counts):
    """Rows 1nLp and 2nLp: the attention forward and backward as wav2vec
    2.0 / UniSpeech train them (no bias, no gate, dropout 0.1, 16 heads) on
    the padded smoke batch (4 rows of 799 frames, 599/349/149 valid keys in
    three), against their plain versions (forward 2 bf16 ulps with dropout,
    dq/dk/dv 2), with bound, plain time and SDPA (the same boolean key mask
    and dropout_p), per w2v_train step."""
    from unispeech_tpu_torch.ops.kernels import flash_attention

    enc = unispeech_large_config().encoder
    gen = torch.Generator().manual_seed(SEED + 25)
    B, T = len(lengths), enc.num_frames(int(lengths.max()))
    H, hd = enc.encoder_attention_heads, enc.encoder_embed_dim // enc.encoder_attention_heads
    q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev, torch.bfloat16)
                for _ in range(3))
    frames = torch.tensor([enc.num_frames(int(n)) for n in lengths.cpu()], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    seed = torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64).to(dev)
    rate = enc.attention_dropout
    fwd = dict(key_padding_mask=kpm, dropout_rate=rate, dropout_seed=seed)
    out, lse = flash_attention.fused_attention(q, kk, v, **fwd, return_lse=True)
    pout, plse = flash_attention.fused_attention_plain(q, kk, v, **fwd, return_lse=True)
    torch.cuda.synchronize()
    err_f = compare(f"fused_attention.nobias.h{H}.padded", out, pout, tol_ulps=2.0)
    dout = (torch.randn(B, T, H, hd, generator=gen) * 1e-2).to(dev, torch.bfloat16)
    args = (q, kk, v, None, None, kpm, None, rate, seed, pout, plse, dout)
    got = flash_attention.fused_attention_backward(*args)
    want = flash_attention.fused_attention_backward_plain(*args)
    torch.cuda.synchronize()
    err_b = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err_b = max(err_b, compare(f"fused_attention_backward.nobias.h{H}.padded.{name}", a, b,
                                   tol_ulps=2.0))
    del got, want, out, lse
    n_fwd, n_bwd = w2v_counts["attn"], w2v_counts["attn_bwd"] // 2  # calls per step
    keys = int(frames.sum())
    f_bound = bound(4 * B * T * H * hd * 2 + B * H * T * 4 + B * T, 4 * H * T * keys * hd,
                    BF16_TC_FLOPS)
    b_bound = bound(8 * B * T * H * hd * 2 + 3 * B * H * T * 4 + B * T,
                    10 * H * T * keys * hd, BF16_TC_FLOPS)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kk, v))
    attend = ~kpm[:, None, None, :]
    ya = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attend, dropout_p=rate)
    rows = [dict(
        name=f"fused_attention.nobias.h{H}.padded_w2v", route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention.cu",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:878",
        launches=w2v_counts["attn"], max_abs_err=err_f,
        ms=n_fwd * cuda_ms(lambda: flash_attention.fused_attention(q, kk, v, **fwd)),
        device_ms=n_fwd * device_ms(lambda: flash_attention.fused_attention(q, kk, v, **fwd)),
        plain_ms=n_fwd * cuda_ms(lambda: flash_attention.fused_attention_plain(q, kk, v, **fwd),
                                 iters=2, warmup=1),
        bound_ms=n_fwd * f_bound[0], bound_by=f_bound[1],
        **library_row(lambda: F.scaled_dot_product_attention(
            qh.detach(), kh.detach(), vh.detach(), attn_mask=attend, dropout_p=rate), n_fwd),
    ), dict(
        name=f"fused_attention_backward.nobias.h{H}.padded_w2v", route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:1159",
        launches=w2v_counts["attn_bwd"], max_abs_err=err_b,
        ms=n_bwd * cuda_ms(lambda: flash_attention.fused_attention_backward(*args)),
        device_ms=n_bwd * device_ms(lambda: flash_attention.fused_attention_backward(*args)),
        plain_ms=n_bwd * cuda_ms(lambda: flash_attention.fused_attention_backward_plain(*args),
                                 iters=2, warmup=1),
        bound_ms=n_bwd * b_bound[0], bound_by=b_bound[1],
        **library_row(grad_fn(ya, (qh, kh, vh), dout.transpose(1, 2).contiguous()), n_bwd))]
    return rows


def w2v_pipeline_phase(counters, tmp):
    """w2v_pipeline: UniSpeech and UniSpeech-SAT pretraining from the
    pipeline phase's 12 wav files through the CLIs' main(argv) in-process:
    train pretrain-wav2vec2 --arch large --mtlalpha 0.5 on two
    comma-separated manifests of 6 files each (two "languages", resampled
    with --multilang-alpha 0.5) with letter transcripts, to update 2 with
    checkpoints every 2, then resumed to 4; then train pretrain-hubert
    --arch large --sat on the pipeline's MFCC labels for 2 updates. Finite
    losses, the resume at update 2, every kernel family launched."""
    import io

    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.train.__main__ import main as train_main

    lines = (tmp / "man" / "train.tsv").read_text().splitlines()
    root, rows = lines[0], lines[1:]
    rng = np.random.default_rng(SEED + 26)
    mans, ltrs = [], []
    for li, part in enumerate((rows[:6], rows[6:])):
        man, ltr = tmp / f"lang{li}.tsv", tmp / f"lang{li}.ltr"
        man.write_text(root + "\n" + "\n".join(part) + "\n")
        ltr.write_text("\n".join(letter_transcript(rng, int(r.split("\t")[1]) / SAMPLE_RATE)
                                 for r in part) + "\n")
        mans.append(str(man))
        ltrs.append(str(ltr))
    Dictionary.letters().save(str(tmp / "letters.txt"))

    def run(argv, what):
        for m, attr in counters:
            setattr(m, attr, 0)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            train_main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tuple(getattr(m, attr) for m, attr in counters)
        records = [json.loads(line) for line in log.getvalue().splitlines()
                   if line.startswith('{"tag": "train"')]
        for r in records:
            keys = ("loss_ctc", "loss_contrastive", "code_perplexity", "prob_perplexity",
                    "loss_spk_m", "contrastive_acc")
            phase("w2v_pipeline", update=r["step"], wall_s=r["elapsed_s"], loss=r["loss_avg"],
                  sample_size=r["sample_size"], **{k: r[k] for k in keys if k in r})
        phase("w2v_pipeline", step=what, seconds=f"{seconds:.2f}",
              launches_l1_conv_attn_fwd_bwd=counts)
        if not all(counts):
            fail(f"w2v_pipeline: {what}: a kernel family was not launched: {counts}")
        if not records or not all(np.isfinite(r["loss_avg"]) for r in records):
            fail(f"w2v_pipeline: {what}: a non-finite loss or no update logged")
        return [r["step"] for r in records]

    ckpt = str(tmp / "w2v_ckpt")
    argv = ["pretrain-wav2vec2", "--arch", "large", "--manifest", ",".join(mans),
            "--transcripts", ",".join(ltrs), "--dict", str(tmp / "letters.txt"),
            "--mtlalpha", "0.5", "--multilang-alpha", "0.5", "--save-interval-updates", "2",
            "--log-interval", "1", "--checkpoint-dir", ckpt, "--export-params",
            str(tmp / "w2v_export.npz")]
    first = run(argv + ["--max-updates", "2"], "pretrain-wav2vec2 --max-updates 2")
    second = run(argv + ["--max-updates", "4"], "pretrain-wav2vec2 --max-updates 4 (resumed)")
    phase("w2v_pipeline", first_run_updates=first, resumed_run_updates=second,
          checkpoints=sorted(int(n) for n in os.listdir(ckpt)))
    if first != [1, 2] or second != [3, 4]:
        fail(f"w2v_pipeline: the resumed run did not start at update 2: {first}, {second}")
    shutil.rmtree(ckpt, ignore_errors=True)
    sat_ckpt = str(tmp / "sat_ckpt")
    sat = run(["pretrain-hubert", "--sat", "--arch", "large", "--manifest",
               str(tmp / "man" / "train.tsv"), "--labels", str(tmp / "lab" / "mfcc.km"),
               "--num-classes", str(PIPE_CLUSTERS), "--label-rate", "100",
               "--max-updates", "2", "--save-interval-updates", "2", "--log-interval", "1",
               "--checkpoint-dir", sat_ckpt], "pretrain-hubert --sat --max-updates 2")
    if sat != [1, 2]:
        fail(f"w2v_pipeline: pretrain-hubert --sat logged updates {sat}")
    shutil.rmtree(sat_ckpt, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from unispeech_tpu_torch.configs import (
        WavLMModelConfig,
        base_encoder_config,
        large_encoder_config,
    )
    from unispeech_tpu_torch.convert.from_jax import jax_params_from_state_dict, save_params_npz
    from unispeech_tpu_torch.data.manifest import load_audio
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.ops.kernels import _build, conv_stack, flash_attention, l1_frontend
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = PhaseClock()

    # 1 device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2 build
    t0 = time.perf_counter()
    lib = _build.build()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}", library=lib.name)
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    clock.done("build")

    # 3 per-kernel parity at the main path's shapes
    cfg = base_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                              dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0)
    gen = torch.Generator().manual_seed(SEED + 1)
    wav, lengths = smoke_batch(dev)
    B, NS = wav.shape
    C = cfg.conv_layers[0][0]
    k0, s0 = cfg.conv_layers[0][1:]
    w1 = (torch.randn(k0, 1, C, generator=gen) * (2.0 / k0) ** 0.5).to(dev)
    t1 = (NS - k0) // s0 + 1
    err_l1, err_l1_nosums = l1_forward_parity(dev, wav, w1, s0)

    conv_inputs = []  # (x, kernel, affine, gelu_in) per block, as the main path calls them
    x = torch.randn(B, t1, C, generator=gen).to(dev, torch.bfloat16)
    affine = ((torch.rand(B, C, generator=gen) + 0.5).to(dev),
              (torch.randn(B, C, generator=gen) * 0.1).to(dev))
    err_conv = 0.0
    for i, (dim, k, s) in enumerate(cfg.conv_layers[1:], start=2):
        w = (torch.randn(k, C, dim, generator=gen) * (2.0 / (k * C)) ** 0.5).to(
            dev, torch.bfloat16)
        first = i == 2
        args = (x, w, x.shape[1], first, True, affine if first else None)
        conv_inputs.append(args)
        y, t_out = conv_stack.conv_gelu_block(*args)
        py, pt = conv_stack.conv_gelu_block_plain(*args)
        torch.cuda.synchronize()
        if t_out != pt:
            fail(f"conv layer {i}: t_out {t_out} != {pt}")
        err_conv = max(err_conv, compare(f"conv_gelu_block.L{i}", y, py))
        x = y

    T = x.shape[1]
    H, D = cfg.encoder_attention_heads, cfg.encoder_embed_dim
    hd = D // H
    q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev, torch.bfloat16)
                for _ in range(3))
    table = (torch.randn(cfg.num_buckets, H, generator=gen) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table, T, T, cfg.num_buckets, cfg.max_distance,
                                dtype=torch.bfloat16)
    gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
    frames = torch.tensor([cfg.num_frames(int(n)) for n in lengths.cpu()], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    attn_args = (q, kk, v, bias, gate, kpm)
    out = flash_attention.fused_attention(*attn_args)
    pout = flash_attention.fused_attention_plain(*attn_args)
    torch.cuda.synchronize()
    err_attn = compare("fused_attention", out, pout)
    amask = torch.where((torch.arange(T)[:, None] - torch.arange(T)[None, :]).abs() > 200,
                        -1e4, 0.0).to(dev)
    out2, lse = flash_attention.fused_attention(*attn_args, attn_mask=amask, return_lse=True)
    pout2, plse = flash_attention.fused_attention_plain(*attn_args, attn_mask=amask,
                                                        return_lse=True)
    torch.cuda.synchronize()
    err_attn = max(err_attn, compare("fused_attention.attn_mask", out2, pout2))
    # a row of length 0 has the mask value as its lse (-2^100 in the kernel,
    # -1e30 in the plain version): lse is held on the rows with a key
    e_lse = float((lse - plse)[frames > 0].abs().max())
    phase("parity", kernel="fused_attention.lse", max_abs_err=f"{e_lse:.3g}", tol="1e-3")
    if not e_lse <= 1e-3:  # fp32 sums in two orders: far below 1e-3 in a log
        fail(f"lse: {e_lse}")
    clock.done("parity")

    # 4 main path: WavLM-Base+ feature extraction through the kernels
    model = WavLM(WavLMModelConfig(encoder=cfg), dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    nparams = sum(p.numel() for p in model.parameters())
    counters = (l1_frontend, conv_stack, flash_attention)

    def run(output_layer=None):
        for c in counters:
            c.launches = 0
        res = model.extract_features(wav, lengths=lengths, output_layer=output_layer)
        torch.cuda.synchronize()
        return res, tuple(c.launches for c in counters)

    n_frames = cfg.num_frames(NS)
    main_out, main_launches = run()
    mid_out, mid_launches = run(output_layer=6)
    # conv: six GEMMs and the first block's H pass
    for name, res, got, want in (("full", main_out, main_launches, (1, 7, 12)),
                                 ("layer6", mid_out, mid_launches, (1, 7, 6))):
        if res.x.shape != (B, n_frames, D) or not torch.isfinite(res.x).all():
            fail(f"{name}: output {tuple(res.x.shape)} not finite (B, {n_frames}, {D})")
        if got != want:
            fail(f"{name}: launches (l1, conv, attention) {got} != {want}")
    with plain_ops():
        plain_x = model.extract_features(wav, lengths=lengths).x
        plain_mid = model.extract_features(wav, lengths=lengths, output_layer=6).x
    # bf16 rounding differences of the two paths, carried through 12 layers
    # of random weights: relative L2 well under 5e-2
    e_full, e_mid = rel_l2(main_out.x, plain_x), rel_l2(mid_out.x, plain_mid)
    phase("main", params=nparams, shape=tuple(main_out.x.shape),
          launches_full=main_launches, launches_layer6=mid_launches,
          rel_l2_vs_plain_full=f"{e_full:.3g}", rel_l2_vs_plain_layer6=f"{e_mid:.3g}",
          tol="5e-2")
    if not (e_full <= 5e-2 and e_mid <= 5e-2):
        fail("kernel path disagrees with the plain path")
    clock.done("main")

    # 5 WavLM-Large feature extraction through the layer_norm extractor
    large = large_phase(dev, wav, lengths, smi)
    clock.done("large")

    # 6 the dump-features CLI on the card
    tmp = _build.BUILD_DIR / "smoke_cli"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        rng = np.random.default_rng(SEED)
        sizes = (88_000, 51_200, 129_600)
        rows = []
        for i, n in enumerate(sizes):
            write_wav(tmp / f"u{i}.wav", rng.standard_normal(n) * 0.1)
            rows.append(f"u{i}.wav\t{n}")
        (tmp / "train.tsv").write_text(f"{tmp}\n" + "\n".join(rows) + "\n")
        save_params_npz(str(tmp / "params.npz"),
                        jax_params_from_state_dict(model.state_dict(), cfg))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "unispeech_tpu_torch.tools", "dump-features",
                        "--feature", "model", "--checkpoint", str(tmp / "params.npz"),
                        "--manifest", str(tmp / "train.tsv"), "--feat-dir", str(tmp / "feat"),
                        "--layer", "6"], cwd=REPO, check=True, timeout=600)
        cli_s = time.perf_counter() - t0
        feats = np.load(tmp / "feat" / "train_0_1.npy")
        lens = [int(n) for n in (tmp / "feat" / "train_0_1.len").read_text().split()]
        if lens != [cfg.num_frames(n) for n in sizes] or feats.shape != (sum(lens), D):
            fail(f"cli: lens {lens}, feats {feats.shape}")
        want = np.concatenate([
            model.extract_features(torch.from_numpy(load_audio(str(tmp / f"u{i}.wav")))
                                   [None].to(dev), output_layer=6).x[0].float().cpu().numpy()
            for i in range(len(sizes))])
        e_cli = float(np.linalg.norm(feats - want) / np.linalg.norm(want))
        phase("cli", seconds=f"{cli_s:.1f}", frames=sum(lens),
              rel_l2_vs_library=f"{e_cli:.3g}", tol="1e-2")
        if not (np.isfinite(feats).all() and e_cli <= 1e-2):
            fail("cli features disagree with the library call")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    clock.done("cli")

    # 7 backward kernels at the pretraining shapes, Base's and Large's forms
    bw = backward_parity(dev, base_encoder_config(relative_position_embedding=True,
                                                  gru_rel_pos=True))
    bw_large = backward_parity(dev, large_encoder_config(relative_position_embedding=True,
                                                         gru_rel_pos=True),
                               B=LARGE_B, ln_form=True)
    clock.done("bwd")

    # 8 pretraining steps, Base then Large; the counts are read per step inside
    train_counts, large_counts = {}, {}
    counters = [(l1_frontend, "launches"), (l1_frontend, "backward_launches"),
                (conv_stack, "launches"), (conv_stack, "backward_launches"),
                (flash_attention, "launches"), (flash_attention, "backward_launches")]
    train = train_phase(dev, counters, train_counts)
    clock.done("train")
    large_train = train_phase(dev, counters, large_counts, arch="large")
    clock.done("large_train")

    # CTC fine-tuning steps at WavLM-Large's full width on the padded batch
    ctc_counts = {}
    ctc = ctc_train_phase(dev, counters, ctc_counts, wav, lengths)
    clock.done("ctc_train")

    # HuBERT-style pretraining from raw audio through the CLIs, then CTC
    # fine-tuning of its export and decoding to a WER
    tmp = _build.BUILD_DIR / "smoke_pipeline"
    try:
        pipeline_phase(counters, tmp)
        clock.done("pipeline")
        ctc_pipeline_phase(counters, tmp)
        clock.done("ctc_pipeline")
        # seq2seq fine-tuning and decoding, the Transformer LM and its fusion
        s2s_counts = {}
        s2s = s2s_train_phase(dev, counters, s2s_counts, wav, lengths)
        clock.done("s2s_train")
        lm = lm_train_phase(dev)
        clock.done("lm_train")
        s2s_decode_s = s2s_pipeline_phase(counters, tmp)
        clock.done("s2s_pipeline")
        # UniSpeech and UniSpeech-SAT pretraining at Large width: steps on
        # the padded batch, then the CLIs on the pipeline's files
        w2v_counts, sat_counts = {}, {}
        w2v = contrastive_train_phase(dev, counters, "w2v_train", wav, lengths, w2v_counts)
        clock.done("w2v_train")
        sat = contrastive_train_phase(dev, counters, "sat_train", wav, lengths, sat_counts)
        clock.done("sat_train")
        w2v_pipeline_phase(counters, tmp)
        clock.done("w2v_pipeline")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 9 the elementwise micro-benchmark at its full shape
    vpu_row = vpu_phase(dev)
    clock.done("vpu")

    # 10 times: forward kernels at the serving shapes (per forward: all
    # launches of a kernel), backward kernels at the pretraining shapes (per
    # train step)
    wav_bf = wav.to(torch.bfloat16)[:, None, :]
    w1_lib = w1.permute(2, 1, 0).to(torch.bfloat16).contiguous()
    l1_bytes = B * NS * 4 + B * t1 * C * 2 + 2 * B * C * 4
    l1_nosums_bytes = B * NS * 4 + B * t1 * C * 2
    l1_flops = 2 * B * t1 * C * k0
    rows = [dict(
        name="l1_conv_with_stats", route="cuda", source="unispeech_tpu_torch/csrc/l1_frontend.cu",
        replaces="unispeech_tpu/ops/pallas/l1_frontend.py:164",
        launches=main_launches[0], max_abs_err=err_l1,
        ms=cuda_ms(lambda: l1_frontend.l1_conv_with_stats(wav, w1, s0)),
        device_ms=device_ms(lambda: l1_frontend.l1_conv_with_stats(wav, w1, s0)),
        plain_ms=cuda_ms(lambda: l1_frontend.l1_conv_with_stats_plain(wav, w1, s0), iters=5),
        bound_ms=1e3 * max(l1_bytes / HBM_BYTES_PER_S, l1_flops / FP32_FLOPS),
        bound_by="bytes" if l1_bytes / HBM_BYTES_PER_S >= l1_flops / FP32_FLOPS
        else "operations",
        **library_row(lambda: F.conv1d(wav_bf, w1_lib, stride=s0)),
    ), dict(
        name="l1_conv_with_stats.no_sums", route="cuda",
        source="unispeech_tpu_torch/csrc/l1_frontend.cu",
        replaces="unispeech_tpu/ops/pallas/l1_frontend.py:164",
        launches=large["launches"][0], max_abs_err=err_l1_nosums,
        ms=cuda_ms(lambda: l1_frontend.l1_conv_with_stats(wav, w1, s0, with_stats=False)),
        device_ms=device_ms(lambda: l1_frontend.l1_conv_with_stats(wav, w1, s0,
                                                                   with_stats=False)),
        plain_ms=cuda_ms(lambda: l1_frontend.l1_conv_with_stats_plain(wav, w1, s0,
                                                                      with_stats=False),
                         iters=5),
        bound_ms=1e3 * max(l1_nosums_bytes / HBM_BYTES_PER_S, l1_flops / FP32_FLOPS),
        bound_by="bytes" if l1_nosums_bytes / HBM_BYTES_PER_S >= l1_flops / FP32_FLOPS
        else "operations",
        **library_row(lambda: F.conv1d(wav_bf, w1_lib, stride=s0)),
    )]
    conv_ms = conv_dev = conv_plain = conv_lib = conv_bound = 0.0
    conv_lib_dev = 0.0
    conv_by = set()
    for args in conv_inputs:
        x, w = args[0], args[1]
        kw = w.shape[0]
        t_out = (x.shape[1] - kw) // 2 + 1
        one = cuda_ms(lambda: conv_stack.conv_gelu_block(*args))
        one_dev = device_ms(lambda: conv_stack.conv_gelu_block(*args))
        conv_ms += one
        conv_dev += one_dev
        conv_plain += cuda_ms(lambda: conv_stack.conv_gelu_block_plain(*args), iters=5)
        xt = x.transpose(1, 2).contiguous()
        wt = w.permute(2, 1, 0).contiguous()
        lib = library_times(lambda: F.conv1d(xt, wt, stride=2))
        conv_lib += lib[0]
        conv_lib_dev += lib[1]
        nbytes = (B * x.shape[1] * C + kw * C * C + B * t_out * C) * 2
        flops = 2 * B * t_out * C * kw * C
        conv_bound += 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS)
        conv_by.add("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_TC_FLOPS
                    else "operations")
        phase("times", kernel=f"conv_gelu_block.T{x.shape[1]}", ms=f"{one:.4f}",
              device_ms=f"{one_dev:.4f}",
              bound_ms=f"{1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS):.4f}",
              tflops=f"{flops / one_dev / 1e9:.1f}")
    rows.append(dict(
        name="conv_gelu_block", route="cuda", source="unispeech_tpu_torch/csrc/conv_stack.cu",
        replaces="unispeech_tpu/ops/pallas/conv_stack.py:156",
        launches=main_launches[1], max_abs_err=max(err_conv, large["err_conv"]), ms=conv_ms,
        device_ms=conv_dev,
        plain_ms=conv_plain,
        bound_ms=conv_bound, bound_by="operations" if "operations" in conv_by else "bytes",
        library_ms=conv_lib, library_device_ms=conv_lib_dev,
    ))
    n_attn = main_launches[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kk, v))
    mask = (gate[..., None] * bias.float()[None]
            + torch.where(kpm, -1e30, 0.0)[:, None, None, :]).to(torch.bfloat16)
    a_bytes = 4 * B * T * D * 2 + H * T * T * 2 + B * H * T * 4 + B * T
    a_flops = 4 * B * H * T * T * hd
    rows.append(dict(
        name="fused_attention", route="cuda", source="unispeech_tpu_torch/csrc/flash_attention.cu",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:878",
        launches=n_attn, max_abs_err=err_attn,
        ms=n_attn * cuda_ms(lambda: flash_attention.fused_attention(*attn_args)),
        device_ms=n_attn * device_ms(lambda: flash_attention.fused_attention(*attn_args)),
        plain_ms=n_attn * cuda_ms(lambda: flash_attention.fused_attention_plain(*attn_args),
                                  iters=5),
        bound_ms=n_attn * 1e3 * max(a_bytes / HBM_BYTES_PER_S, a_flops / BF16_TC_FLOPS),
        bound_by="bytes" if a_bytes / HBM_BYTES_PER_S >= a_flops / BF16_TC_FLOPS
        else "operations",
        **library_row(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                      n_attn),
    ))
    rows += backward_times(bw, train_counts)
    rows += backward_times(bw_large, large_counts)
    rows.append(finetune_attention_backward(dev, lengths, ctc_counts))
    rows += nobias_attention_rows(dev, lengths, w2v_counts)
    rows.append(vpu_row)
    del bw, bw_large
    # each kernel family's launches in one frozen and one unfrozen CTC
    # fine-tuning step at WavLM-Large's width (its forms of the family)
    family = (("l1_conv_with_stats.no_sums", 0), ("l1_conv_with_stats", None),
              ("l1_conv_backward", 1), ("conv_gelu_block_backward", 3),
              ("conv_gelu_block", 2), ("fused_attention_backward", 5),
              ("fused_attention", 4), ("vpu_micro", None))
    for r in rows:
        idx = next(i for prefix, i in family if r["name"].startswith(prefix))
        r["ctc_launches_frozen"] = 0 if idx is None else ctc_counts["frozen"][idx]
        r["ctc_launches_unfrozen"] = 0 if idx is None else ctc_counts["unfrozen"][idx]
        r["s2s_launches_frozen"] = 0 if idx is None else s2s_counts["frozen"][idx]
        r["s2s_launches_unfrozen"] = 0 if idx is None else s2s_counts["unfrozen"][idx]
    for r in rows:
        phase("times", **{k: (f"{v:.4f}" if isinstance(v, float) else
                              "null" if v is None else v)
                          for k, v in r.items() if k not in ("route", "source", "replaces")})

    fwd_ms = cuda_ms(lambda: model.extract_features(wav, lengths=lengths), iters=5, warmup=2)
    audio_s = float(lengths.sum()) / SAMPLE_RATE
    # host time to enqueue one forward on an idle queue: close to forward_ms
    # means the host, not the card, sets the pace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.extract_features(wav, lengths=lengths)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    # where one forward's device time goes, by kernel name
    profile_once(lambda: model.extract_features(wav, lengths=lengths), "profile")
    phase("e2e", forward_ms=f"{fwd_ms:.3f}", host_enqueue_ms=f"{host_ms:.3f}",
          audio_seconds=audio_s,
          padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s=f"{audio_s / (fwd_ms / 1e3):.1f}",
          kernel_share=f"{(rows[0]['ms'] + rows[2]['ms'] + rows[3]['ms']) / fwd_ms:.3f}")
    phase("e2e_train", step_ms=f"{train['step_ms']:.3f}",
          host_enqueue_ms=f"{train['host_ms']:.3f}",
          audio_seconds_per_step=train["audio_s"],
          audio_sec_per_s=f"{train['audio_s'] / (train['step_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{train['peak_gb']:.2f}",
          profiled_busy_ms=f"{train['busy_ms']:.3f}", profiled_wall_ms=f"{train['wall_ms']:.3f}",
          kernel_launches_per_step=train["launches"])
    phase("e2e_large_train", step_ms=f"{large_train['step_ms']:.3f}",
          host_enqueue_ms=f"{large_train['host_ms']:.3f}",
          audio_seconds_per_step=large_train["audio_s"],
          audio_sec_per_s=f"{large_train['audio_s'] / (large_train['step_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{large_train['peak_gb']:.2f}",
          profiled_busy_ms=f"{large_train['busy_ms']:.3f}",
          profiled_wall_ms=f"{large_train['wall_ms']:.3f}",
          kernel_launches_per_step=large_train["launches"])
    fp, up = ctc["frozen_profile"], ctc["unfrozen_profile"]
    phase("e2e_ctc_train", params=ctc["params"], frozen_step_ms=f"{ctc['frozen_ms']:.3f}",
          unfrozen_step_ms=f"{ctc['unfrozen_ms']:.3f}",
          host_enqueue_frozen_ms=f"{ctc['host_frozen_ms']:.3f}",
          host_enqueue_unfrozen_ms=f"{ctc['host_unfrozen_ms']:.3f}",
          audio_seconds_per_step=ctc["audio_s"], padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s_frozen=f"{ctc['audio_s'] / (ctc['frozen_ms'] / 1e3):.1f}",
          audio_sec_per_s_unfrozen=f"{ctc['audio_s'] / (ctc['unfrozen_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{ctc['peak_gb']:.2f}",
          profiled_busy_ms_frozen=f"{fp[0]:.3f}", profiled_wall_ms_frozen=f"{fp[1]:.3f}",
          profiled_busy_ms_unfrozen=f"{up[0]:.3f}", profiled_wall_ms_unfrozen=f"{up[1]:.3f}",
          kernel_launches_frozen=fp[2], kernel_launches_unfrozen=up[2])
    sp = s2s["profile"]
    phase("e2e_s2s_train", params=s2s["params"], frozen_step_ms=f"{s2s['frozen_ms']:.3f}",
          unfrozen_step_ms=f"{s2s['unfrozen_ms']:.3f}",
          host_enqueue_frozen_ms=f"{s2s['host_frozen_ms']:.3f}",
          host_enqueue_unfrozen_ms=f"{s2s['host_unfrozen_ms']:.3f}",
          audio_seconds_per_step=s2s["audio_s"], padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s_frozen=f"{s2s['audio_s'] / (s2s['frozen_ms'] / 1e3):.1f}",
          audio_sec_per_s_unfrozen=f"{s2s['audio_s'] / (s2s['unfrozen_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{s2s['peak_gb']:.2f}", profiled_busy_ms_unfrozen=f"{sp[0]:.3f}",
          profiled_wall_ms_unfrozen=f"{sp[1]:.3f}", kernel_launches_unfrozen=sp[2],
          greedy_decode_ms=f"{s2s['greedy_ms']:.1f}", beam1_decode_ms=f"{s2s['beam1_ms']:.1f}",
          beam5_decode_ms=f"{s2s['beam_ms']:.1f}", decode_len=S2S_DECODE_LEN)
    phase("e2e_lm_train", params=lm["params"], step_ms=f"{lm['step_ms']:.3f}",
          tokens_per_s=f"{lm['tokens_per_step'] / (lm['step_ms'] / 1e3):.0f}")
    phase("e2e_s2s_pipeline", **{f"decode_{k}_s": f"{v:.2f}" for k, v in s2s_decode_s.items()})
    for name, e in (("e2e_w2v_train", w2v), ("e2e_sat_train", sat)):
        phase(name, params=e["params"], step_ms=f"{e['step_ms']:.3f}",
              host_enqueue_ms=f"{e['host_ms']:.3f}", audio_seconds_per_step=e["audio_s"],
              padded_seconds=B * NS / SAMPLE_RATE,
              audio_sec_per_s=f"{e['audio_s'] / (e['step_ms'] / 1e3):.1f}",
              peak_memory_gb=f"{e['peak_gb']:.2f}", profiled_busy_ms=f"{e['busy_ms']:.3f}",
              profiled_wall_ms=f"{e['wall_ms']:.3f}", kernel_launches_per_step=e["launches"])
    clock.done("times")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
