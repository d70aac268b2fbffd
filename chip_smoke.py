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
    fp32     feature extraction at the models' default dtype (fp32): (a) the
             fp32 forward kernels against their plain versions (TF32 off) at
             the serving shapes with a row of length 0: the L1 with and
             without its sums (y1 rtol 1e-5 / atol 1e-6, the sums within
             1e-5 of the sum of |terms|), the six conv blocks in both
             extractors' forms and attention at T = 799 for Base+ (also
             with a (T, S) mask), Large (16 x 64) and hd 80 (16 x 80):
             relative L2 <= 1e-5, max abs <= 1e-4 of max |plain|, lse 1e-4
             on the rows with a key; (b) WavLM-Base+ and WavLM-Large built
             without a dtype from seed 0 (Large through a reference-layout
             .pt and convert/fairseq.py), extract_features on the smoke
             batch: launches (1, 7, 12) and (1, 12, 24), fp32 and finite,
             the plain path within relative L2 1e-4; (c) each fp32 kernel's
             wall and device ms, bound (bytes, or its operations as 3xTF32
             at 495 TFLOP/s; the L1's at 67 TFLOP/s), plain version and
             library call (F.conv1d fp32, SDPA fp32 with a float mask), the
             forwards' ms, audio-seconds per second and peak memory
    tf32_pin the fp32 convolutions under PyTorch's default cuDNN flag
             (allow_tf32 True, which runs an fp32 cuDNN convolution in
             TF32): WavLM-Base+ built without a dtype, extract_features with
             the flag on against its plain path with it off (the fp32
             models' gate, relative L2 1e-4), and a seed-0 ECAPA-TDNN head
             (the verification head, fp32) over its layer features on the
             card with the flag on against the CPU (the speaker heads'
             gate, 1e-4 of the output's scale); printed beside them, the
             positional conv's F.conv1d with the flag on against the pinned
             conv (no gate: what the pin removes); the flag restored after
    fp32_bwd the fp32 backward kernels and the fp32 attention dropout (TF32
             off for the plain versions) at the pretraining shapes, in the
             Base forms and the Large layer_norm forms (a row of length 0,
             dO 0 on it): the products (dq, dk, dv, dx, the dropout
             forward's out) relative L2 <= 1e-5 and max abs <= 1e-4 of max
             |plain|, the sums taken in a run-dependent order (fp32 atomics:
             dW of the L1 and the conv blocks, da, db, dgate; TMA tile
             reductions: dbias) within 1e-5 of the sum of |terms| per
             element, lse 1e-4 on the rows with a key, the dropout
             forward's keep mask equal to attention_keep over all 768
             keys; then the attention forward and backward above head dim
             64 (their width-80, width-96 and width-128 forms): X-Large's
             16 heads of 80 over its frames of the smoke batch and a fifth
             row of length 0, hd 72, 96, 104, 120 and 128 on 3 rows of 333 (one of
             length 0); the forward with key padding and dropout 0.1 (no
             bias), with the gated bias and key padding, and with key
             padding and a (T, S) -1e4 band mask (every key tile runs):
             out by the products' rule (the rows whose open keys all sit
             behind the band within 2^-10, one fp32 ulp at 1e4), lse 1e-4
             plus 2 ulps on the rows with a key, one launch per call, the
             row of length 0 the mean of v where there is no dropout; the
             backward in the first two
             forms by the same rules, two launches per call
    fp32_train, fp32_large_train  phase 8's pretraining steps with the
             models built without a dtype (fp32, the default): launches per
             step as in bf16, the gradients against the plain path per
             tensor |g - g_plain| <= 1e-3 |g_plain| + 1e-6 |global|, 20
             steps of falling loss; step ms, host enqueue, audio-seconds
             per second, peak memory, a profiled step
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
    dist     training across processes on the one card: train pretrain-hubert
             --arch large --fsdp with the multi-process flags (NCCL, world
             size 1) on the pipeline's files for 2 updates, its losses
             against the pipeline's unsharded run; the bench's Large config
             at 4 of its 24 layers (dropout 0, a precomputed mask) one step
             on 4 crops of 245,840 samples in one process, then in two
             processes on the card over
             gloo on a (2, 1) mesh (2 rows each) and a (1, 2) mesh (tensor
             parallel, 8 heads each): every gradient tensor against the
             one-process step's by the train gate, sample size, loss and
             launches per rank, ms per step, peak memory, all-reduce calls,
             bytes and ms; the attention kernels forward and backward on 8
             heads with a rank's bias rows and gate against their plain
             versions; mix_batch_device on the card against the CPU on the
             same draws (noise clips pre-cut from the pipeline's files)
    ctc_pipeline  train finetune-ctc --arch large --w2v-path <the pipeline's
             export> on letter transcripts of the 12 files (valid set the
             same, --best-metric wer, freeze 2, checkpoints every 2) to
             update 2, resumed to 4; decode --arch large with the viterbi
             decoder, the kenlm decoder (a tiny ARPA LM and lexicon) and the
             ensemble of both exports; finite losses, a valid WER at each
             validation, the best checkpoint by WER, the resume, one
             hypothesis per file, the WER report, attention backward only
             from update 3 on
    xlarge   HuBERT X-Large (fairseq hubert_xlarge_lv60k.yaml: 48 layers,
             width 1280, FFN 5120, 16 heads of 80, no rel-pos bias) through
             --arch large --encoder-json: (a) the attention kernels at head
             dims 16, 24, 32, 36 (a copy padded to 40), 80, 120 and 128
             against their plain versions on 3 rows of 333 frames (one of
             length 0, dO 0 on it), 4 heads, gated bias + key padding
             (forward 1 bf16 ulp) and key padding + dropout 0.1 (2 ulps),
             lse 1e-3, backward dq/dk/dv 2 ulps, dbias/dgate 2e-3; (b) the
             CTC model finetune-ctc builds at full width and depth (seed-0
             weights, bf16, ~0.96 B parameters) on the padded smoke batch:
             the eval forward's kernel path against its plain path (5e-2)
             with its launches, 5 steps (2 frozen) with launch counts
             (attention 48/96 forward, 0/96 backward), one unfrozen step's
             gradients against the plain path, step ms, host enqueue,
             audio-seconds per second, peak memory, 5 unfrozen steps of
             falling loss; rows 1X / 2X (the hd-80 attention forward per
             eval forward, its backward per unfrozen step, with SDPA); (c)
             finetune-ctc 2 updates on the pipeline's files with
             --export-params and decode --decoder viterbi of the export:
             finite losses, launches, one hypothesis per file, the WER report
    fp32_xlarge  xlarge (b) with the model built without a dtype (fp32, the
             default; 962,534,816 parameters, seed 0) through the fp32
             kernels: the eval forward within relative L2 1e-4 of its plain
             path, launches (1, 0, 12, 0, 48, 0); 5 steps, 2 frozen, with
             launches per step (frozen 48 attention forward, unfrozen 96
             forward and 96 backward: the fp32 backward at hd 80, row 2fX);
             one unfrozen step's gradients by the fp32 rule (1e-3 |g| +
             1e-6 |global|); 5 unfrozen steps of falling loss from a fresh
             head; step ms, host enqueue, audio-seconds per second, peak
             memory, a profiled unfrozen step; rows 1fX (the fp32 forward
             at hd 80 per eval forward), 1dfX (with dropout per unfrozen
             step) and 2fX (the width-80 forms, csrc/*_f32_mid.cu) against
             their plain versions by f32_check, with bound and SDPA in fp32
    fp32_xlsr2b  fp32_xlarge's checks and gates on CTC fine-tuning at XLS-R
             2B's width (1920 wide, FFN 7680, 16 heads of 120, the
             positional conv in 16 groups of 120; 12 of its 48 layers;
             fp32, seed 0, 565,894,176 parameters): launches (1, 0, 12, 0,
             12, 0) per eval forward, attention 12 / 24 forward and 0 / 24
             backward per frozen / unfrozen step, the learning steps at
             lr 3.33e-5 (5e-5 at the other widths); rows 1fW (the fp32
             forward at hd 120 per eval forward, the width-128 form,
             csrc/flash_attention_f32_wide.cu), 1dfW (with dropout per
             unfrozen step) and 2fW (the backward per unfrozen step,
             csrc/flash_attention_bwd_f32.cu's width-128 form)
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
    convert  WavLM-Large as verification --arch large builds it (seed 0)
             written as a reference .pt (the state dict under "model") and
             read back through load_reference_checkpoint and
             wavlm_state_dict_from_reference: a strict load, every tensor
             equal; the same for a fairseq CTC checkpoint of that backbone
             (w2v_encoder.w2v_model., w2v_encoder.proj) through
             ctc_state_dict_from_fairseq, and its backbone through
             strip_w2v_prefix; then the .npz files the speaker CLIs read
             (the Large and Base+ backbones in the JAX layout, seed-0 ECAPA
             heads, a seed-0 diarization head)
    speaker  python -m unispeech_tpu_torch.downstream.verification --arch
             large, in-process, on 24 synthesised wav files of 3-20 s (6
             speakers) and 48 trials (24 same-file), batches of 8: launches
             per batch forward (L1 1 without the sums, conv 12, attention
             24), every trial scored and finite, same-file cosines >= 0.999,
             the most padded file alone against its batch row within rel L2
             5e-2, the ECAPA head on the card against the CPU (fp32, 1e-4 of
             the output's scale), seconds per call, trials/s, peak memory;
             the same with --arch base (Base+, the L1 with its sums: 1, 7,
             12); then downstream.diarize --arch large on recordings of 30,
             90 and 240 s of 2-3 speakers in turns, against their reference
             RTTM (chunks of 2000 frames, median width 11): launches per
             recording, frame counts, parsed RTTMs, a finite DER, peak
             memory; the attention kernel at the 240 s length (T 11,999,
             H*T*S > 2^31 bias elements) on its first and last 256 query
             rows against the plain version (1 bf16 ulp); the 90 s
             backbone's kernel path against its plain path (5e-2); the
             diarization head on the card against the CPU on one chunk
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
             unfrozen fine-tuning step (CTC and seq2seq), per verification
             batch and per diarized recording; the fp32 backward kernels and
             dropout forward per fp32 train step (SDPA fp32, the fp32
             F.conv1d input + weight backward and the L1's fp32 weight
             backward as library calls); the fp32 X-Large step
             (e2e_fp32_xlarge, beside the bf16 step) and the fp32 step at
             XLS-R 2B's width (e2e_fp32_xlsr2b); audio-seconds per second of
             the forward, of the train steps, of the fine-tuning steps and
             of the UniSpeech and UniSpeech-SAT steps; the speaker CLIs'
             seconds per call, trials/s, DER and peak memory

The line before the last is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import contextlib
import io
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
# the same in fp32 (fp32_train, fp32_large_train): both paths compute in fp32
# and differ only by 3xTF32 rounding and summation order, 50x tighter
GRAD_TOL_F32, GRAD_FLOOR_F32 = 1e-3, 1e-6
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


def sum_check(name: str, got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor) -> float:
    """An fp32 sum taken in a run-dependent order (fp32 atomics) against its
    plain version: each element within SUM_RTOL (1e-5) of the sum of its
    terms' magnitudes (``ops/kernels/sum_terms.py``). Returns the max abs
    error."""
    from unispeech_tpu_torch.ops.kernels.sum_terms import SUM_RTOL, sum_error

    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    worst = sum_error(got, want, terms)
    max_abs = float((got.float() - want.float()).abs().max())
    phase("parity", kernel=name, max_abs_err=f"{max_abs:.3g}",
          max_err_over_sum_abs_terms=f"{worst:.3g}", tol=f"{SUM_RTOL:g}")
    if not worst <= SUM_RTOL:
        fail(f"{name}: an element differs by {worst} of the sum of |terms|")
    return max_abs


def backward_parity(dev, cfg, B=TRAIN_B, ln_form=False, dtype=torch.bfloat16):
    """Phase 7 (bf16) and fp32_bwd (fp32): each backward kernel (and the
    attention forward with dropout) against its plain version at the
    pretraining shapes of ``cfg`` with B crops, in ``dtype``. ``ln_form``:
    the forms WavLM-Large's layer_norm extractor runs (the L1 backward
    without the sums' cotangents; every conv block with the input GELU, no
    affine and no output GELU). bf16: the products within 2 bf16 ulps at the
    tensor's scale, the fp32 sums within relative L2 1e-3 (2e-3 for dbias,
    dgate). fp32: the products (dq, dk, dv, dx, the dropout forward's out)
    by f32_check (relative L2 1e-5, max abs 1e-4 of max |plain|), the sums
    taken in a run-dependent order (dW, da, db, dbias, dgate) within 1e-5 of
    the sum of |terms| per element, lse within 1e-4 on the rows with a key,
    and the dropout forward's keep mask equal to attention_keep. Returns
    the inputs the times phase reuses and the max abs errors."""
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend
    from unispeech_tpu_torch.ops.kernels.philox import attention_keep
    from unispeech_tpu_torch.ops.kernels.sum_terms import attn_terms, conv_terms, l1_terms
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(SEED + 2 + 10 * ln_form + 20 * f32)
    NS = TRAIN_NS
    pre_ = "fp32." if f32 else ""
    sfx = ".ln_form" if ln_form else ""
    C = cfg.conv_layers[0][0]
    k0, s0 = cfg.conv_layers[0][1:]
    t1 = (NS - k0) // s0 + 1

    def product(name, got, want, ulps):
        return f32_check(name, got, want) if f32 else compare(name, got, want, tol_ulps=ulps)

    wav = (torch.randn(B, NS, generator=gen) * 0.1).to(dev)
    w1 = (torch.randn(k0, 1, C, generator=gen) * (2.0 / k0) ** 0.5).to(dev)
    dy1 = (torch.randn(B, t1, C, generator=gen) * 1e-3).to(dev, dtype)
    ds1 = ds2 = None
    if not ln_form:
        ds1 = (torch.randn(B, C, generator=gen) * 1e-4).to(dev)
        ds2 = (torch.randn(B, C, generator=gen) * 1e-4).to(dev)
    l1_args = (wav, w1, s0, dy1, ds1, ds2, dtype)
    name = pre_ + "l1_conv_backward.dw" + (".no_sums" if ln_form else "")
    got, want = l1_frontend.l1_conv_backward(*l1_args), l1_frontend.l1_conv_backward_plain(*l1_args)
    # fp32 sums over B * t1 rows (295,002 at B = 6) in two orders (per-thread
    # rows and cross-tile atomics vs one einsum): relative L2 1e-3 in bf16
    err_l1 = (sum_check(name, got, want, l1_terms(*l1_args[:6])) if f32 else
              rel_check(name, got, want, 1e-3))
    if not ln_form:
        # a second geometry, (k, stride) = (8, 4), through the kernel's
        # generic instantiation at a pretraining-sized t1 (61,459 rows)
        t8 = (NS - 8) // 4 + 1
        gen8 = torch.Generator().manual_seed(SEED + 5)
        args8 = (wav, (torch.randn(8, 1, C, generator=gen8) * 0.5).to(dev), 4,
                 (torch.randn(B, t8, C, generator=gen8) * 1e-3).to(dev, dtype), ds1, ds2, dtype)
        got, want = l1_frontend.l1_conv_backward(*args8), l1_frontend.l1_conv_backward_plain(*args8)
        if f32:
            sum_check(pre_ + "l1_conv_backward.dw.k8s4", got, want, l1_terms(*args8[:6]))
        else:
            rel_check("l1_conv_backward.dw.k8s4", got, want, 1e-3)
        del args8
    del got, want

    conv_args = []  # (x, w, valid, gelu_in, gelu_out, affine, dy, pre) per block
    x = torch.randn(B, t1, C, generator=gen).to(dev, dtype)
    affine = ((torch.rand(B, C, generator=gen) + 0.5).to(dev),
              (torch.randn(B, C, generator=gen) * 0.1).to(dev))
    err_conv = 0.0
    for i, (dim, k, _) in enumerate(cfg.conv_layers[1:], start=2):
        w = (torch.randn(k, C, dim, generator=gen) * (2.0 / (k * C)) ** 0.5).to(dev, dtype)
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
            product(f"{pre_}conv_gelu_block.L{i}.pre", pre, ppre, 1.0)
        dy = (torch.randn(B, t_out, C, generator=gen) * 1e-2).to(dev, dtype)
        args = (x, w, x.shape[1], gelu_in, gelu_out, ab, dy, pre)
        conv_args.append(args)
        got = conv_stack.conv_gelu_block_backward(*args)
        want = conv_stack.conv_gelu_block_backward_plain(*args)
        torch.cuda.synchronize()
        err_conv = max(err_conv, product(f"{pre_}conv_gelu_block_backward{sfx}.L{i}.dx",
                                         got[0], want[0], 2.0))
        if f32:
            terms = conv_terms(*args, want[0])
            sum_check(f"{pre_}conv_gelu_block_backward{sfx}.L{i}.dw", got[1], want[1], terms[0])
            if ab is not None:
                sum_check(f"{pre_}conv_gelu_block_backward.L2.da", got[2], want[2], terms[1])
                sum_check(f"{pre_}conv_gelu_block_backward.L2.db", got[3], want[3], terms[2])
            del terms
        else:
            rel_check(f"conv_gelu_block_backward{sfx}.L{i}.dw", got[1], want[1], 1e-3)
            if ab is not None:
                rel_check("conv_gelu_block_backward.L2.da", got[2], want[2], 1e-3)
                rel_check("conv_gelu_block_backward.L2.db", got[3], want[3], 1e-3)
        del got, want
        # the next block's input: the LayerNorm of y in the layer_norm form
        x = F.layer_norm(y.float(), (dim,)).to(dtype) if ln_form else y

    T = x.shape[1]
    H, D = cfg.encoder_attention_heads, cfg.encoder_embed_dim
    sfx = f".h{H}" if ln_form else ""
    q, kk, v = (torch.randn(B, T, H, D // H, generator=gen).to(dev, dtype) for _ in range(3))
    table = (torch.randn(cfg.num_buckets, H, generator=gen) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table, T, T, cfg.num_buckets, cfg.max_distance, dtype=dtype)
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
    err_drop = product(f"{pre_}fused_attention.dropout{sfx}", out, pout, 2.0)
    # a row of length 0 has the mask value as its lse (-2^100 in the kernel,
    # -1e30 in the plain version): lse is held on the rows with a key
    e_lse = float((lse - plse)[frames > 0].abs().max())
    lse_tol = 1e-4 if f32 else 1e-3
    phase("parity", kernel=f"{pre_}fused_attention.dropout{sfx}.lse", max_abs_err=f"{e_lse:.3g}",
          tol=lse_tol)
    if not e_lse <= lse_tol:
        fail(f"lse with dropout{sfx} ({dtype}): {e_lse}")
    del out, lse
    if f32:
        # the keep mask at this shape: q = k = 0 makes every probability 1/S,
        # and v = columns [c0, c0 + hd) of the identity over the keys turns
        # out[t, j] into keep(t, c0 + j) / (S (1 - rate))
        z = torch.zeros_like(q)
        keep = attention_keep(seed, B, H, T, T, rate)
        hd = q.shape[-1]
        for c0 in range(0, T, hd):
            w = min(hd, T - c0)
            eye = torch.zeros(T, hd, device=dev)
            eye[:, :w] = torch.eye(T, device=dev)[:, c0:c0 + w]
            vv = eye[None, :, None, :].expand(B, T, H, hd).contiguous()
            got = flash_attention.fused_attention(z, z, vv, dropout_rate=rate, dropout_seed=seed)
            if not torch.equal(got.permute(0, 2, 1, 3)[..., :w] != 0, keep[..., c0:c0 + w]):
                fail(f"fp32 dropout{sfx}: the keep mask differs from attention_keep at keys "
                     f"{c0}-{c0 + w - 1}")
        phase("parity", kernel=f"{pre_}fused_attention.dropout{sfx}.keep_mask",
              equal_to="attention_keep", keys=T)
        del z, keep, vv, got
    # no loss term reaches a row of length 0, so training's dO is 0 there
    # (with p recomputed from the mask-valued lse, the backward of such a row
    # is exact only then); both backwards take the plain forward's out and lse
    dout = (torch.randn(B, T, H, D // H, generator=gen) * 1e-2
            * (frames.cpu() > 0)[:, None, None, None]).to(dev, dtype)
    attn_args = (q, kk, v, bias, gate, kpm, None, rate, seed, pout, plse, dout)
    got = flash_attention.fused_attention_backward(*attn_args)
    want = flash_attention.fused_attention_backward_plain(*attn_args)
    torch.cuda.synchronize()
    err_attn = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err_attn = max(err_attn, product(f"{pre_}fused_attention_backward{sfx}.{name}", a, b,
                                         2.0))
    if f32:
        terms = attn_terms(*attn_args)
        sum_check(f"{pre_}fused_attention_backward{sfx}.dbias", got[3], want[3], terms[0])
        sum_check(f"{pre_}fused_attention_backward{sfx}.dgate", got[4], want[4], terms[1])
        del terms
    else:
        # fp32 sums whose order varies (atomics over key tiles and the batch)
        rel_check(f"fused_attention_backward{sfx}.dbias", got[3], want[3], 2e-3)
        rel_check(f"fused_attention_backward{sfx}.dgate", got[4], want[4], 2e-3)
    return dict(l1=l1_args, conv=conv_args, attn=attn_args, fwd_drop=(q, kk, v, fwd),
                err=(err_l1, err_conv, err_attn, err_drop), ln_form=ln_form, dtype=dtype)


def train_phase(dev, counters, train_counts, arch="base", dtype=torch.bfloat16):
    """Phase 8 (arch "base") and large_train (arch "large"): masked-prediction
    pretraining steps on the card, the model in bf16; fp32_train and
    fp32_large_train (``dtype`` fp32): the same models built without a dtype
    (fp32, the default), through the fp32 kernels, their gradients held to
    the plain path by the fp32 rule. Fills ``train_counts`` with the launch
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

    f32 = dtype == torch.float32
    tag = ("fp32_" if f32 else "") + ("train" if arch == "base" else "large_train")
    # built without a dtype in fp32: the models' default
    dtype_kw = {} if f32 else {"dtype": dtype}
    tol, floor = (GRAD_TOL_F32, GRAD_FLOOR_F32) if f32 else (GRAD_TOL, GRAD_FLOOR)
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
    model = HubertPretrainModel(pcfg, **dtype_kw, generator=torch.Generator().manual_seed(SEED))
    if any(p.dtype != torch.float32 for p in model.parameters()) or (
            f32 and model.dtype != torch.float32):
        fail(f"{tag}: the model's parameters or compute dtype are not fp32 where expected")
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
    model0 = HubertPretrainModel(dataclasses.replace(pcfg, encoder=enc0), **dtype_kw)
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
        worst.append((diff / (tol * ref + floor * total), name, diff / max(ref, 1e-30)))
    worst.sort(reverse=True)
    for ratio, name, rel in worst[:5]:
        phase(tag, grad_vs_plain=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{ratio:.3g}")
    phase(tag, grad_tol=f"{tol} * |g| + {floor} * |global|",
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
    WavLM-Large's forms with ``bw["ln_form"]``; in bw["dtype"]), per train
    step (all launches of a kernel in one step). Bounds: the bytes of the
    dtype; the products' operations at bf16's tensor-core peak, or in fp32
    as 3xTF32 (three TF32 products each) at the TF32 peak; the L1's on the
    CUDA cores."""
    from unispeech_tpu_torch.ops.kernels import (
        TF32_TC_FLOPS,
        conv_stack,
        flash_attention,
        l1_frontend,
    )

    err_l1, err_conv, err_attn, err_drop = bw["err"]
    ln_form, dt = bw["ln_form"], bw["dtype"]
    f32 = dt == torch.float32
    esz = 4 if f32 else 2
    # the products' (multiplier, peak): 3xTF32 at the TF32 peak, or bf16
    mult, peak = (3, TF32_TC_FLOPS) if f32 else (1, BF16_TC_FLOPS)
    pre_, src = ("fp32.", "_f32.cu") if f32 else ("", ".cu")
    wav, w1, s0, dy1, ds1, ds2, _ = bw["l1"]
    B, NS = wav.shape
    k0, _, C = w1.shape
    t1 = dy1.shape[1]
    xb = wav.to(dt)[:, None, :]
    wl = w1.permute(2, 1, 0).to(dt).contiguous().requires_grad_()
    yl = F.conv1d(xb, wl, stride=s0)
    # with the sums' cotangents the kernel recomputes y1 (2 B t1 C k more
    # operations) and reads ds1, ds2; without them dW = wav-windows^T dy alone
    l1_bound = bound(B * t1 * C * esz + B * NS * 4 + k0 * C * 4
                     + (0 if ds1 is None else 2 * B * C * 4),
                     (2 if ds1 is None else 4) * B * t1 * C * k0, FP32_FLOPS)
    rows = [dict(
        name=pre_ + "l1_conv_backward" + (".no_sums" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/l1_frontend" + src,
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
        phase("times", kernel=f"{pre_}conv_gelu_block_backward{'.ln_form' if ln_form else ''}.L{i}",
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
        b_ms, by = bound((2 * B * x.shape[1] * C + 2 * k * C * C + 2 * B * t_out * C) * esz
                         + k * C * C * 4, mult * 2 * 2 * B * t_out * C * k * C, peak)
        c_bound += b_ms
        c_by.add(by)
    rows.append(dict(
        name=pre_ + "conv_gelu_block_backward" + (".layer_norm_form" if ln_form else ""),
        route="cuda", source="unispeech_tpu_torch/csrc/conv_stack" + src,
        replaces="unispeech_tpu/ops/pallas/conv_stack.py:359",
        launches=train_counts["conv_bwd"], max_abs_err=err_conv, ms=c_ms, device_ms=c_dev,
        plain_ms=c_plain,
        bound_ms=c_bound, bound_by="operations" if "operations" in c_by else "bytes",
        library_ms=c_lib, library_device_ms=c_lib_dev))
    q, kk, v, bias, gate, kpm, _, rate, seed, out, lse, dout = bw["attn"]
    B, T, H, hd = q.shape
    n = train_counts["attn"]  # backward calls: one per forward call
    a_bound = bound(8 * B * T * H * hd * esz + 2 * H * T * T * esz + 3 * B * H * T * 4 + B * T,
                    mult * 10 * B * H * T * T * hd, peak)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kk, v))
    mask = (gate[..., None] * bias.float()[None]
            + torch.where(kpm, -1e30, 0.0)[:, None, None, :]).to(dt).requires_grad_()
    ya = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    rows.append(dict(
        name=pre_ + "fused_attention_backward" + (f".h{H}" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention_bwd" + src,
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
        phase("times", kernel=f"{pre_}fused_attention_backward.{tag}", ms_per_call=f"{one:.4f}")
    # the dropout forward at the pretraining shape, per train step; SDPA with
    # the same dropout rate is the library call (it draws another mask)
    q, kk, v, fwd = bw["fwd_drop"]
    B, T, H, hd = q.shape
    d_bound = bound(4 * B * T * H * hd * esz + H * T * T * esz + 2 * B * H * T * 4 + B * T,
                    mult * 4 * B * H * T * T * hd, peak)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kk, v))
    dmask = (fwd["gate"][..., None] * fwd["bias"].float()[None]
             + torch.where(fwd["key_padding_mask"], -1e30, 0.0)[:, None, None, :]).to(dt)
    rows.append(dict(
        name=pre_ + "fused_attention.dropout" + (f".h{H}" if ln_form else ""), route="cuda",
        source="unispeech_tpu_torch/csrc/flash_attention" + src,
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
        argv = pipeline_train_argv(man, str(lab / "mfcc.km")) + [
            "--max-updates", str(max_updates), "--checkpoint-dir", ckpt,
            "--export-params", export]
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
        return records

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
    first_records = train(4)
    first = [r["step"] for r in first_records]
    second = [r["step"] for r in train(6)]
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
    return dict(argv=pipeline_train_argv(man, str(lab / "mfcc.km")),
                losses=[r["loss_avg"] for r in first_records])


def pipeline_train_argv(man: str, labels: str) -> list:
    """The pipeline's pretrain-hubert arguments, without the update count
    and the output paths."""
    return ["pretrain-hubert", "--manifest", man, "--labels", labels, "--arch", "large",
            "--num-classes", str(PIPE_CLUSTERS), "--label-rate", "100", "--mixing-prob", "0.2",
            "--save-interval-updates", "2", "--log-interval", "1"]


# -- dist: training across processes on the one card ---------------------------

DIST_B = 4  # rows of the dist phase's Large step: 2 per data rank under (2, 1)
# loss of a step split over ranks against the one-process step: bf16 sums of
# the two shapes in other orders
DIST_LOSS_TOL = 1e-2
WORKER_TIMEOUT = 400


DIST_LAYERS = 4  # of Large's 24: the gates compare ranks with one process at any depth


def dist_model_config():
    """The bench's Large config at DIST_LAYERS layers (width, heads and FFN
    Large's) with dropout, layerdrop and activation dropout 0: one step
    across ranks computes what one process computes."""
    from unispeech_tpu_torch.configs import HubertPretrainConfig, MaskConfig, large_encoder_config

    enc = large_encoder_config(encoder_layers=DIST_LAYERS,
                               relative_position_embedding=True, gru_rel_pos=True,
                               encoder_layerdrop=0.0, dropout=0.0, attention_dropout=0.0,
                               activation_dropout=0.0, remat_ffn=True, remat_layers=False,
                               scan_layers=False)
    return HubertPretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.8, mask_length=10),
                                num_classes=(N_CLASSES,), final_dim=768)


def dist_batch(pcfg):
    """DIST_B crops of 245,840 samples, frame labels and a precomputed time
    mask, on the CPU, from a seed."""
    gen = torch.Generator().manual_seed(SEED + 12)
    T = pcfg.encoder.num_frames(TRAIN_NS)
    return {"source": torch.randn(DIST_B, TRAIN_NS, generator=gen),
            "targets": torch.randint(0, N_CLASSES, (DIST_B, T, 1), generator=gen),
            "boundary_mask": torch.rand(DIST_B, T, generator=gen) < 0.5}


def kernel_counters():
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

    return [(l1_frontend, "launches"), (l1_frontend, "backward_launches"),
            (conv_stack, "launches"), (conv_stack, "backward_launches"),
            (flash_attention, "launches"), (flash_attention, "backward_launches")]


def dist_step(dev, mesh=None):
    """One Large train step of the dist config on ``dist_batch`` (this data
    rank's rows on ``mesh``) through create_train_state, shard_train_state
    and make_train_step: its numbers, launch counts, the whole gradients
    (collective on a mesh), then ms per step and peak memory over two more
    steps."""
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.parallel.sharding import full_grads, local_rows
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
        shard_train_state,
    )
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    pcfg = dist_model_config()
    batch = dist_batch(pcfg)
    if mesh is not None:
        batch = local_rows(batch)
    batch = {k: v.to(dev) for k, v in batch.items()}
    model = HubertPretrainModel(pcfg, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, OptimConfig(lr=5e-4, schedule="fixed"), device=dev)
    if mesh is not None:
        state = shard_train_state(state, mesh, tensor_parallel=mesh["model"].size() > 1)
    step = make_train_step(make_hubert_loss_fn(state.model, HubertCriterionConfig()))
    counters = kernel_counters()
    for m, attr in counters:
        setattr(m, attr, 0)
    met = step(state, batch, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    counts = tuple(getattr(m, attr) for m, attr in counters)
    out = dict(loss=float(met["loss_per_sample"]), grad_norm=float(met["grad_norm"]),
               sample_size=int(met["sample_size"]), launches=counts)
    grads = {k: v.float().cpu() for k, v in full_grads(state.model).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        step(state, batch, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / 2
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out, grads, state


def allreduce_ms(tensors, group, iters: int = 3) -> float:
    """CUDA-event ms of one sum of ``tensors`` over ``group`` (flat buffers)."""
    from unispeech_tpu_torch.train.state import all_reduce_sum

    bufs = [t.detach().clone() for t in tensors]
    all_reduce_sum(bufs, group)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        all_reduce_sum(bufs, group)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dist_worker(kind: str, rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a dist run, started by ``dist_phase``: "fsdp_cli" runs the
    training CLI (its arguments in outdir/fsdp_cli.json) with the launch
    counts; "dp" and "tp" run ``dist_step`` over gloo on a (2, 1) or (1, 2)
    mesh, rank 0 saving the whole gradients."""
    import torch.distributed as dist

    out = pathlib.Path(outdir)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    if kind == "fsdp_cli":
        from unispeech_tpu_torch.train.__main__ import main as train_main

        argv = json.loads((out / "fsdp_cli.json").read_text())
        for m, attr in counters:
            setattr(m, attr, 0)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            train_main(argv)
        torch.cuda.synchronize()
        res = dict(seconds=time.perf_counter() - t0,
                   launches=tuple(getattr(m, attr) for m, attr in counters),
                   records=[json.loads(line) for line in log.getvalue().splitlines()
                            if line.startswith('{"tag": "train"')],
                   backend=dist.get_backend(), world=dist.get_world_size(),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    else:
        from unispeech_tpu_torch.parallel.bootstrap import maybe_initialize_distributed
        from unispeech_tpu_torch.parallel.sharding import make_mesh

        maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
        mesh = make_mesh(*((2, 1) if kind == "dp" else (1, 2)), device_type="cuda")
        # count the collectives of dist_step's three steps (alike): calls, bytes
        calls = {"n": 0, "bytes": 0}
        real = dist.all_reduce

        def counting(t, *a, **k):
            calls["n"] += 1
            calls["bytes"] += t.numel() * t.element_size()
            return real(t, *a, **k)

        dist.all_reduce = counting
        res, grads, state = dist_step(dev, mesh)
        dist.all_reduce = real
        res["allreduce_calls_per_step"] = calls["n"] // 3
        res["allreduce_mbytes_per_step"] = calls["bytes"] / 3 / 2**20
        if kind == "dp":
            # the data ranks' gradient sync, as the step makes it
            res["grad_allreduce_ms"] = allreduce_ms([p.grad for p in state.optimizer.params],
                                                    mesh["data"].get_group())
        else:
            # one activation sum over the model ranks, as a layer makes four
            enc = dist_model_config().encoder
            x = torch.randn(DIST_B, enc.num_frames(TRAIN_NS), enc.encoder_embed_dim, device=dev,
                            dtype=torch.bfloat16)
            res["activation_allreduce_ms"] = allreduce_ms([x], mesh["model"].get_group())
        res["peak_gb_all"] = torch.cuda.max_memory_allocated() / 1e9
        if rank == 0:
            torch.save(grads, out / f"grads_{kind}.pt")
        dist.barrier()
        dist.destroy_process_group()
    (out / f"{kind}_rank{rank}.json").write_text(json.dumps(res))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(kind: str, world: int, outdir: pathlib.Path) -> list:
    """Start ``world`` ranks of ``dist_worker`` and wait for all; their
    results by rank. Any rank that fails (or outlives WORKER_TIMEOUT) fails
    the phase, after the others are stopped."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "dist-worker", kind,
                               str(r), str(world), str(port), str(outdir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:], flush=True)
            fail(f"dist {kind}: rank {r} exited {p.returncode}")
    return [json.loads((outdir / f"{kind}_rank{r}.json").read_text()) for r in range(world)]


def grad_gate(tag: str, got: dict, want: dict) -> float:
    """The per-tensor gradient gate against the one-process step; returns
    the worst ratio to the tolerance."""
    if sorted(got) != sorted(want):
        fail(f"{tag}: gradient names differ")
    total = float(torch.sqrt(sum((g * g).sum() for g in want.values())))
    worst = []
    for name, b in want.items():
        a = got[name]
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{tag}: gradient of {name}: shape {tuple(a.shape)} or non-finite")
        diff, ref = float((a - b).norm()), float(b.norm())
        worst.append((diff / (GRAD_TOL * ref + GRAD_FLOOR * total), name, diff / max(ref, 1e-30)))
    worst.sort(reverse=True)
    for ratio, name, rel in worst[:3]:
        phase(tag, grad_vs_one_process=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{ratio:.3g}")
    phase(tag, grad_tol=f"{GRAD_TOL} * |g| + {GRAD_FLOOR} * |global|",
          global_grad_norm=f"{total:.4g}", tensors=len(worst))
    if worst[0][0] > 1.0:
        fail(f"{tag}: gradient of {worst[0][1]} disagrees with the one-process step")
    return worst[0][0]


def tp_attention_parity(dev):
    """The attention kernels forward and backward on a model rank's 8 of
    WavLM-Large's 16 heads (head dim 64), its bias rows and gate, at the
    dist step's shapes, against their plain versions."""
    from unispeech_tpu_torch.ops.kernels import flash_attention
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    enc = dist_model_config().encoder
    B, T, H = DIST_B, enc.num_frames(TRAIN_NS), enc.encoder_attention_heads // 2
    hd = enc.encoder_embed_dim // enc.encoder_attention_heads
    gen = torch.Generator().manual_seed(SEED + 13)
    q, k, v = (torch.randn(B, T, H, hd, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    table = (torch.randn(enc.num_buckets, 2 * H, generator=gen) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table[:, H:], T, T, enc.num_buckets, enc.max_distance,
                                dtype=torch.bfloat16)  # model rank 1's rows
    gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
    kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
    out, lse = flash_attention.fused_attention(q, k, v, bias, gate, kpm, return_lse=True)
    pout, plse = flash_attention.fused_attention_plain(q, k, v, bias, gate, kpm,
                                                       return_lse=True)
    torch.cuda.synchronize()
    err = compare("fused_attention.tp8", out, pout)
    dout = (torch.randn(B, T, H, hd, generator=gen) * 1e-2).to(dev, torch.bfloat16)
    args = (q, k, v, bias, gate, kpm, None, 0.0, None, pout, plse, dout)
    got = flash_attention.fused_attention_backward(*args)
    want = flash_attention.fused_attention_backward_plain(*args)
    torch.cuda.synchronize()
    err_b = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err_b = max(err_b, compare(f"fused_attention_backward.tp8.{name}", a, b, tol_ulps=2.0))
    rel_check("fused_attention_backward.tp8.dbias", got[3], want[3], 2e-3)
    rel_check("fused_attention_backward.tp8.dgate", got[4], want[4], 2e-3)
    return err, err_b


def mixing_on_card(dev, tmp):
    """mix_batch_device's math on the card against the CPU on the same
    draws, at the pretraining batch's shape, noise clips pre-cut from the
    pipeline's files; ms per call on each."""
    from unispeech_tpu_torch.data.mixing import (
        MixingConfig,
        NoiseStore,
        mix_batch_device,
        mix_with_draws,
        mixing_draws,
    )

    B, T = TRAIN_B, TRAIN_NS
    cfg = MixingConfig(mixing_prob=0.5, mixing_noise_prob=0.5, normalize_after=True)
    clips = NoiseStore(str(tmp / "man" / "train.tsv")).precut(np.random.default_rng(SEED), 4, T)
    gen = torch.Generator().manual_seed(SEED + 14)
    audio = torch.randn(B, T, generator=gen) * 0.1
    draws = mixing_draws(gen, B, T, cfg, n_noise=len(clips))
    noise = torch.from_numpy(clips)
    want = mix_with_draws(audio, draws, cfg, noise)
    audio_d, noise_d = audio.to(dev), noise.to(dev)
    draws_d = {k: v.to(dev) for k, v in draws.items()}
    got = mix_with_draws(audio_d, draws_d, cfg, noise_d)
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    mixed = int((draws["u_sel"] < cfg.mixing_prob).sum())
    card_ms = cuda_ms(lambda: mix_batch_device(gen, audio_d, None, cfg, noise_d), iters=10)
    t0 = time.perf_counter()
    mix_with_draws(audio, draws, cfg, noise)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    phase("dist", mix_batch_device_max_abs_err=f"{err:.3g}", tol=f"{tol:.3g}", rows_mixed=mixed,
          card_ms=f"{card_ms:.3f}", cpu_ms=f"{cpu_ms:.1f}", shape=(B, T))
    if not (torch.isfinite(got).all() and err <= tol and 0 < mixed < B):
        fail("dist: mix_batch_device on the card disagrees with the CPU")
    return card_ms


def dist_phase(dev, tmp, pipe):
    """(a) pretrain-hubert --arch large --fsdp over NCCL at world size 1 on
    the pipeline's files, 2 updates, against the pipeline's unsharded run;
    (b) two processes on the card over gloo, mesh (2, 1), one Large step on
    2 of the 4 rows each; (c) the same on mesh (1, 2), tensor parallel on 8
    heads each; each against the one-process step on the 4 rows (per-tensor
    gradient gate, sample size, loss, launches per rank); the attention
    kernels on 8 heads; (d) mix_batch_device on the card against the CPU."""
    out = tmp / "dist"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # (a)
    argv = pipe["argv"] + ["--max-updates", "2", "--checkpoint-dir", str(out / "ckpt"), "--fsdp",
                           "--coordinator-address", f"127.0.0.1:{free_port()}",
                           "--num-processes", "1", "--process-id", "0"]
    (out / "fsdp_cli.json").write_text(json.dumps(argv))
    (a,) = run_workers("fsdp_cli", 1, out)
    losses = [r["loss_avg"] for r in a["records"]]
    phase("dist", run="fsdp_cli", backend=a["backend"], world=a["world"],
          seconds=f"{a['seconds']:.2f}", losses=",".join(f"{x:.5f}" for x in losses),
          unsharded_losses=",".join(f"{x:.5f}" for x in pipe["losses"][:2]),
          launches_l1_conv_attn_fwd_bwd=tuple(a["launches"]), peak_gb=f"{a['peak_gb']:.2f}")
    if a["backend"] != "nccl" or len(losses) != 2 or not all(a["launches"]) or not all(
            abs(x - y) <= DIST_LOSS_TOL * abs(y) for x, y in zip(losses, pipe["losses"])):
        fail("dist (a): the FSDP CLI run disagrees with the unsharded pipeline run")
    shutil.rmtree(out / "ckpt", ignore_errors=True)

    # the one-process step on all 4 rows, then (b) and (c)
    ref, ref_grads, state = dist_step(dev)
    del state
    torch.cuda.empty_cache()
    if not all(ref["launches"]):
        fail(f"dist: a kernel family was not launched in the one-process step: "
             f"{ref['launches']}")
    phase("dist", run="one_process", rows=DIST_B, loss=f"{ref['loss']:.5f}",
          sample_size=ref["sample_size"], grad_norm=f"{ref['grad_norm']:.4f}",
          launches_l1_conv_attn_fwd_bwd=tuple(ref["launches"]), step_ms=f"{ref['step_ms']:.1f}",
          peak_gb=f"{ref['peak_gb']:.2f}")
    res = {"fsdp_cli": a, "one_process": ref}
    for kind in ("dp", "tp"):
        ranks = run_workers(kind, 2, out)
        grads = torch.load(out / f"grads_{kind}.pt", weights_only=True)
        (out / f"grads_{kind}.pt").unlink()
        ratio = grad_gate(f"dist_{kind}", grads, ref_grads)
        del grads
        for r, x in enumerate(ranks):
            phase("dist", run=kind, rank=r, loss=f"{x['loss']:.5f}", sample_size=x["sample_size"],
                  grad_norm=f"{x['grad_norm']:.4f}",
                  launches_l1_conv_attn_fwd_bwd=tuple(x["launches"]),
                  step_ms=f"{x['step_ms']:.1f}", peak_gb=f"{x['peak_gb']:.2f}",
                  allreduce_calls_per_step=x["allreduce_calls_per_step"],
                  allreduce_mbytes_per_step=f"{x['allreduce_mbytes_per_step']:.1f}",
                  **{k: f"{x[k]:.2f}" for k in ("grad_allreduce_ms", "activation_allreduce_ms")
                     if k in x})
            if x["sample_size"] != ref["sample_size"] or tuple(x["launches"]) != tuple(
                    ref["launches"]) or abs(x["loss"] - ref["loss"]) > DIST_LOSS_TOL * abs(
                    ref["loss"]):
                fail(f"dist ({kind}) rank {r}: sample size, launches or loss differ from "
                     "the one-process step")
        res[kind] = dict(ranks=ranks, grad_gate=ratio)
    res["tp_attention_err"] = tp_attention_parity(dev)
    res["mix_card_ms"] = mixing_on_card(dev, tmp)
    shutil.rmtree(out, ignore_errors=True)
    return res


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



# HuBERT X-Large (fairseq examples/hubert/config/pretrain/hubert_xlarge_lv60k.yaml,
# the hubert_xlarge_ll60k_finetune_ls960 release): WavLM-Large's structure at
# 48 layers, width 1280, FFN 5120, 16 heads of 80, no relative position bias
XLARGE_JSON = json.dumps(dict(encoder_layers=48, encoder_embed_dim=1280,
                              encoder_ffn_embed_dim=5120, encoder_attention_heads=16,
                              relative_position_embedding=False, gru_rel_pos=False))
# XLS-R 2B (Babu et al., arXiv:2111.09296, Table 1: 48 layers, width 1920,
# FFN 7680, 16 heads of 120), the widest head of the wav2vec 2.0 line, on
# the same pre-LN, layer_norm-extractor encoder; 12 of its 48 layers, to fit
# chip_smoke.py's time
XLSR2B_JSON = json.dumps(dict(encoder_layers=12, encoder_embed_dim=1920,
                              encoder_ffn_embed_dim=7680, encoder_attention_heads=16,
                              relative_position_embedding=False, gru_rel_pos=False))
XL_HEAD_DIMS = (16, 24, 32, 36, 80, 120, 128)  # 36 runs on a copy padded to 40
# over XL_LEARN_STEPS = 5 the loss falls from ~8.1 to ~5.3 in both dtypes
XL_FREEZE, XL_STEPS, XL_LEARN_STEPS = 2, 5, 5


def xlarge_config(freeze: int, encoder_json: str = XLARGE_JSON):
    """The CtcFinetuneModel finetune-ctc --arch large --encoder-json
    XLARGE_JSON (or ``encoder_json``) builds: X-Large's encoder (dropout
    0.1, attention dropout 0.1, remat_layers), time mask 0.65/10, final
    dropout 0.1, the letter dictionary."""
    from unispeech_tpu_torch.configs import MaskConfig, large_encoder_config, override_encoder
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig

    enc = override_encoder(large_encoder_config(relative_position_embedding=True,
                                                gru_rel_pos=True), encoder_json)
    return CtcFinetuneConfig(encoder=enc, vocab_size=len(LETTERS) + 4, apply_mask=True,
                             time_mask=MaskConfig(mask_prob=0.65, mask_length=10),
                             freeze_finetune_updates=freeze, final_dropout=0.1)


def xlsr2b_config(freeze: int):
    """xlarge_config at XLSR2B_JSON: the positional conv in its 16 groups
    of 120 channels."""
    return xlarge_config(freeze, XLSR2B_JSON)


def xlarge_head_dims(dev):
    """xlarge (a): the attention kernels at the head dims other than 64
    against their plain versions on 3 rows of T = S = 333 (lengths 333, 200
    and 0, dO 0 on the row of length 0) and 4 heads, in two forms: the
    gated bias with key padding (forward 1 bf16 ulp) and key padding with
    dropout 0.1 and no bias (forward 2 ulps); lse within 1e-3 on the rows
    with a key; the backward of the plain forward's out and lse on both
    sides (the row of length 0 adds nothing: its dO is 0, ROADMAP 3.5),
    dq/dk/dv within 2 bf16 ulps, dbias/dgate relative L2 2e-3. Returns the
    max abs error of the forwards and of the backwards."""
    from unispeech_tpu_torch.ops.kernels import flash_attention

    gen = torch.Generator().manual_seed(SEED + 31)
    B, T, H = 3, 333, 4
    frames = torch.tensor([T, 200, 0], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    err_f = err_b = 0.0
    for hd in XL_HEAD_DIMS:
        q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(3))
        bias = torch.randn(H, T, T, generator=gen).to(dev, torch.bfloat16)
        gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
        seed = torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64).to(dev)
        dout = (torch.randn(B, T, H, hd, generator=gen) * 1e-2).to(dev, torch.bfloat16)
        dout[2] = 0  # the row of length 0, as training's padding rows
        for form, kw, ulps in (
                ("bias_gate_kpm", dict(bias=bias, gate=gate, key_padding_mask=kpm), 1.0),
                ("nobias_kpm_drop", dict(key_padding_mask=kpm, dropout_rate=0.1,
                                         dropout_seed=seed), 2.0)):
            name = f"fused_attention.hd{hd}.{form}"
            out, lse = flash_attention.fused_attention(q, kk, v, **kw, return_lse=True)
            pout, plse = flash_attention.fused_attention_plain(q, kk, v, **kw, return_lse=True)
            torch.cuda.synchronize()
            err_f = max(err_f, compare(name, out, pout, tol_ulps=ulps))
            e_lse = float((lse - plse)[frames > 0].abs().max())
            phase("parity", kernel=f"{name}.lse", max_abs_err=f"{e_lse:.3g}", tol="1e-3")
            if not e_lse <= 1e-3:
                fail(f"{name}: lse {e_lse}")
            args = (q, kk, v, kw.get("bias"), kw.get("gate"), kpm, None,
                    kw.get("dropout_rate", 0.0), kw.get("dropout_seed"))
            got = flash_attention.fused_attention_backward(*args, pout, plse, dout)
            want = flash_attention.fused_attention_backward_plain(*args, pout, plse, dout)
            torch.cuda.synchronize()
            for gname, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
                err_b = max(err_b, compare(f"{name}.backward.{gname}", a, b, tol_ulps=2.0))
            for gname, a, b in zip(("dbias", "dgate"), got[3:], want[3:]):
                if (a is None) != (b is None):
                    fail(f"{name}: {gname} present on one side only")
                if a is not None:
                    rel_check(f"{name}.backward.{gname}", a, b, 2e-3)
    return err_f, err_b


def xlarge_learning(model, step, batch, gen, dev, lr):
    """XL_LEARN_STEPS unfrozen steps of ``step`` on one batch at the fixed
    rate ``lr``, from a fresh head (seed SEED + 34); returns the losses."""
    from unispeech_tpu_torch.models.encoder import reset_parameters
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state

    fresh = torch.nn.Linear(model.proj.in_features, model.proj.out_features)
    reset_parameters(fresh, torch.Generator().manual_seed(SEED + 34))
    model.proj.load_state_dict(fresh.state_dict())
    state = create_train_state(model, OptimConfig(lr=lr, schedule="fixed"), device=dev)
    state.step = XL_FREEZE
    return [float(step(state, batch, gen)["loss_per_sample"]) for _ in range(XL_LEARN_STEPS)]


def xlarge_train_phase(dev, counters, wav, lengths, card, dtype=torch.bfloat16,
                       make_config=xlarge_config, tag=None, head_dim=80, lr=5e-5):
    """xlarge (b): HuBERT X-Large CTC fine-tuning at full width and depth
    (the model finetune-ctc --arch large --encoder-json XLARGE_JSON builds,
    seed-0 weights, bf16) on the padded smoke batch with random letter
    transcripts: the eval forward's kernel path against its plain path
    (relative L2 5e-2) with its launches; 5 steps, the first 2 frozen, with
    launch counts per step; one unfrozen step's gradients, kernel path
    against plain path (GRAD_TOL, GRAD_FLOOR); step ms, host enqueue,
    audio-seconds per second, peak memory; XL_LEARN_STEPS unfrozen steps on one batch
    from a fresh head at the fixed rate ``lr``, the loss must fall. fp32_xlarge (``dtype`` fp32): the
    same model built without a dtype (fp32, the default), through the fp32
    kernels (the attention backward at hd 80 is row 2fX): the eval forward
    within relative L2 1e-4 of its plain path, the gradients by the fp32
    rule (GRAD_TOL_F32, GRAD_FLOOR_F32), and one profiled unfrozen step.
    ``make_config`` (freeze updates -> the CtcFinetuneConfig), ``tag`` and
    ``head_dim`` (the config's, or the phase fails) run the same checks on
    another width: fp32_xlsr2b (xlsr2b_config, hd 120). Returns the counts
    and numbers."""
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.ctc import CtcFinetuneModel
    from unispeech_tpu_torch.ops.kernels import flash_attention
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step
    from unispeech_tpu_torch.train.tasks import make_ctc_finetune_loss_fn

    f32 = dtype == torch.float32
    tag = tag or ("fp32_xlarge" if f32 else "xlarge")
    fwd_tol = 1e-4 if f32 else 5e-2
    tol, floor = (GRAD_TOL_F32, GRAD_FLOOR_F32) if f32 else (GRAD_TOL, GRAD_FLOOR)
    d = Dictionary.letters()
    cfg = make_config(XL_FREEZE)
    enc = cfg.encoder
    if enc.encoder_embed_dim // enc.encoder_attention_heads != head_dim:
        fail(f"{tag}: the head dim is not {head_dim}")
    t0 = time.perf_counter()
    # fp32: built without a dtype, the models' default
    model = CtcFinetuneModel(cfg, **({} if f32 else {"dtype": dtype}),
                             generator=torch.Generator().manual_seed(SEED)).to(dev)
    build_s = time.perf_counter() - t0
    if any(p.dtype != torch.float32 for p in model.parameters()) or model.dtype != dtype:
        fail(f"{tag}: parameters not fp32 or compute dtype {model.dtype} is not {dtype}")
    nparams = sum(p.numel() for p in model.parameters())
    B = wav.shape[0]
    rng = np.random.default_rng(SEED + 32)
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
    L = enc.encoder_layers

    def reset():
        for m, attr in counters:
            setattr(m, attr, 0)

    # the eval forward (serving): kernel path against plain path
    model.eval()
    reset()
    with torch.no_grad():
        logits = model(wav, lengths, deterministic=True, step=XL_FREEZE).logits
    torch.cuda.synchronize()
    fwd_counts = tuple(getattr(m, attr) for m, attr in counters)
    with torch.no_grad(), plain_ops():
        plain_logits = model(wav, lengths, deterministic=True, step=XL_FREEZE).logits
    e_fwd = rel_l2(logits, plain_logits)
    if not torch.isfinite(logits).all() or fwd_counts != (1, 0, 12, 0, L, 0):
        fail(f"{tag}: eval forward launches {fwd_counts} or non-finite logits")
    phase(tag, params=nparams, build_s=f"{build_s:.1f}", logits=tuple(logits.shape),
          eval_launches_l1_conv_attn_fwd_bwd=fwd_counts, rel_l2_vs_plain=f"{e_fwd:.3g}", tol=fwd_tol)
    if not e_fwd <= fwd_tol:
        fail(f"{tag}: the forward's kernel path disagrees with the plain path")
    del logits, plain_logits
    model.train()

    state = create_train_state(model, OptimConfig(lr=5e-5, warmup_steps=2, total_steps=100,
                                                  schedule="tri_stage", hold_steps=40),
                               device=dev)
    step = make_train_step(make_ctc_finetune_loss_fn(model))
    gen = torch.Generator().manual_seed(SEED + 33)
    xl_counts = {}
    for i in range(XL_STEPS):
        reset()
        frozen = model.frozen(state.step)
        met = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = tuple(getattr(m, attr) for m, attr in counters)
        kept = L - met["layers_dropped"]
        want = (1, 0, 12, 0) + ((kept, 0) if frozen else (2 * kept, 2 * kept))
        loss, gnorm = float(met["loss_per_sample"]), float(met["grad_norm"])
        phase(tag, step=i, frozen=frozen, loss_per_token=f"{loss:.4f}",
              grad_norm=f"{gnorm:.4f}", ntokens=int(met["sample_size"]),
              layers_dropped=met["layers_dropped"], launches_l1_conv_attn_fwd_bwd=counts)
        if counts != want:
            fail(f"{tag} step {i}: launches {counts} != {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"{tag} step {i}: loss {loss}, grad_norm {gnorm}")
        xl_counts.setdefault("frozen" if frozen else "unfrozen", counts)

    # one unfrozen step's gradients, kernel path against plain path: no
    # masks, no dropout (the eval loss), the same weights
    loss_eval = make_ctc_finetune_loss_fn(model, deterministic=True)

    def grads():
        model.zero_grad(set_to_none=True)
        loss, ss, _ = loss_eval(batch, None, XL_FREEZE)
        (loss / torch.clamp(ss, min=1.0)).backward()
        return [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                else p.grad.float().clone() for p in model.parameters()]

    gk = grads()
    with plain_ops():
        gp = grads()
    model.zero_grad(set_to_none=True)
    total = float(torch.sqrt(sum((g * g).sum() for g in gp)))
    worst = []
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        diff, ref = float((a - b).norm()), float(b.norm())
        worst.append((diff / (tol * ref + floor * total), name, diff / max(ref, 1e-30)))
    del gk, gp
    worst.sort(reverse=True)
    for ratio, name, rel in worst[:5]:
        phase(tag, grad_vs_plain=name, rel_l2=f"{rel:.3g}", of_tolerance=f"{ratio:.3g}")
    phase(tag, grad_tol=f"{tol} * |g| + {floor} * |global|",
          global_grad_norm=f"{total:.4g}", tensors=len(worst))
    if worst[0][0] > 1.0:
        fail(f"{tag}: gradient of {worst[0][1]}: kernel path disagrees with the plain path")

    # ms per step (back to back), host enqueue on an idle queue, peak memory
    def timed(frozen, n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state.step = 0 if frozen else XL_FREEZE
            step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        state.step = 0 if frozen else XL_FREEZE
        t0 = time.perf_counter()
        step(state, batch, gen)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms, host

    frozen_ms, host_frozen = timed(True)
    torch.cuda.reset_peak_memory_stats()
    unfrozen_ms, host_unfrozen = timed(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = (0.0, 0.0, 0)
    if f32:  # where an unfrozen fp32 step's device time goes

        def unfrozen():
            state.step = XL_FREEZE
            step(state, batch, gen)

        prof = profile_once(unfrozen, f"{tag}_profile")

    del state
    losses = xlarge_learning(model, step, batch, gen, dev, lr)
    phase(tag, learning_first=f"{losses[0]:.4f}", learning_last=f"{losses[-1]:.4f}",
          steps=len(losses), lr=f"{lr:.3g}", losses=",".join(f"{x:.3f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"{tag}: {XL_LEARN_STEPS} steps on one batch: loss {losses[0]} -> "
             f"{losses[-1]} did not fall")
    audio_s = float(lengths.sum()) / SAMPLE_RATE
    phase(tag, frozen_step_ms=f"{frozen_ms:.3f}", unfrozen_step_ms=f"{unfrozen_ms:.3f}",
          host_enqueue_frozen_ms=f"{host_frozen:.3f}",
          host_enqueue_unfrozen_ms=f"{host_unfrozen:.3f}",
          audio_sec_per_s_frozen=f"{audio_s / (frozen_ms / 1e3):.1f}",
          audio_sec_per_s_unfrozen=f"{audio_s / (unfrozen_ms / 1e3):.1f}",
          peak_memory_gb=f"{peak_gb:.2f}", card=card.replace(" ", "_"))
    del model
    torch.cuda.empty_cache()
    return dict(params=nparams, counts=xl_counts, fwd_counts=fwd_counts, e_fwd=e_fwd,
                frozen_ms=frozen_ms, unfrozen_ms=unfrozen_ms, host_frozen_ms=host_frozen,
                host_unfrozen_ms=host_unfrozen, peak_gb=peak_gb, audio_s=audio_s,
                busy_ms=prof[0], wall_ms=prof[1], launches=prof[2])


def xlarge_attention_rows(dev, lengths, xl, dtype=torch.bfloat16, make_config=xlarge_config,
                          path="xlarge"):
    """Rows 1X and 2X: the attention forward as X-Large serves (key
    padding, no bias, no dropout, hd 80, 16 heads) per eval forward, and
    its backward as X-Large fine-tunes (dropout 0.1) per unfrozen step, on
    the padded smoke batch (4 rows of 799 frames, 599/349/149 valid keys
    in three), against their plain versions (forward 1 bf16 ulp; dropout
    forward and dq/dk/dv 2), with bound, plain time and SDPA (the same
    boolean key mask; dropout_p for the backward). ``dtype`` fp32 (``xl``
    from fp32_xlarge): rows 1fX, 1dfX (the dropout forward per unfrozen
    step) and 2fX, held by f32_check, their bounds as 3xTF32 at the TF32
    peak, SDPA in fp32; their source is the width-80 forms' (``_mid.cu``).
    ``make_config`` and ``path`` (the rows' suffix) as fp32_xlsr2b gives
    them: rows 1fW, 1dfW and 2fW at hd 120, the forward's width-128 form
    (``_f32_wide.cu``) and the backward's (``_bwd_f32.cu``)."""
    from unispeech_tpu_torch.ops.kernels import TF32_TC_FLOPS, flash_attention

    f32 = dtype == torch.float32
    pre_, esz = ("fp32.", 4) if f32 else ("", 2)
    enc = make_config(0).encoder
    hd = enc.encoder_embed_dim // enc.encoder_attention_heads
    # the forward's and the backward's source files
    fwd_src, bwd_src = ("flash_attention_f32.cu", "flash_attention_bwd_f32.cu") if f32 else (
        "flash_attention.cu", "flash_attention_bwd.cu")
    if f32 and flash_attention.f32_width(hd) in (80, 96):  # the width-80 / width-96 forms
        fwd_src, bwd_src = "flash_attention_f32_mid.cu", "flash_attention_bwd_f32_mid.cu"
    elif f32 and flash_attention.f32_width(hd) == 128:  # the forward's width-128 form
        fwd_src = "flash_attention_f32_wide.cu"
    mult, peak = (3, TF32_TC_FLOPS) if f32 else (1, BF16_TC_FLOPS)

    def check(name, got, want, ulps=1.0):
        return f32_check(name, got, want) if f32 else compare(name, got, want, tol_ulps=ulps)

    gen = torch.Generator().manual_seed(SEED + 35)
    B, T = len(lengths), enc.num_frames(int(lengths.max()))
    H = enc.encoder_attention_heads
    q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev, dtype) for _ in range(3))
    frames = torch.tensor([enc.num_frames(int(n)) for n in lengths.cpu()], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    seed = torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64).to(dev)
    rate = enc.attention_dropout
    out = flash_attention.fused_attention(q, kk, v, key_padding_mask=kpm)
    pout = flash_attention.fused_attention_plain(q, kk, v, key_padding_mask=kpm)
    torch.cuda.synchronize()
    err_f = check(f"{pre_}fused_attention.nobias.hd{hd}.h{H}.padded", out, pout)
    drop = dict(key_padding_mask=kpm, dropout_rate=rate, dropout_seed=seed)
    dout_k, dlse = flash_attention.fused_attention(q, kk, v, **drop, return_lse=True)
    dpout, dplse = flash_attention.fused_attention_plain(q, kk, v, **drop, return_lse=True)
    torch.cuda.synchronize()
    err_d = check(f"{pre_}fused_attention.nobias.hd{hd}.h{H}.padded.dropout", dout_k, dpout, 2.0)
    dout = (torch.randn(B, T, H, hd, generator=gen) * 1e-2).to(dev, dtype)
    args = (q, kk, v, None, None, kpm, None, rate, seed, dpout, dplse, dout)
    got = flash_attention.fused_attention_backward(*args)
    want = flash_attention.fused_attention_backward_plain(*args)
    torch.cuda.synchronize()
    err_b = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err_b = max(err_b, check(f"{pre_}fused_attention_backward.nobias.hd{hd}.h{H}.padded.{name}",
                                 a, b, 2.0))
    del got, want, out, pout, dout_k, dlse
    n_fwd = xl["fwd_counts"][4]  # calls per eval forward
    n_drop = xl["counts"]["unfrozen"][4]  # dropout forward calls per unfrozen step
    n_bwd = xl["counts"]["unfrozen"][5] // 2  # backward calls per unfrozen step
    keys = int(frames.sum())
    f_bound = bound(4 * B * T * H * hd * esz + B * T, mult * 4 * H * T * keys * hd, peak)
    b_bound = bound(8 * B * T * H * hd * esz + 3 * B * H * T * 4 + B * T,
                    mult * 10 * H * T * keys * hd, peak)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kk, v))
    attend = ~kpm[:, None, None, :]
    ya = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attend, dropout_p=rate)
    fwd = dict(key_padding_mask=kpm)

    def forward_row(name, n, kw, err, dropout_p):
        return dict(
            name=name, route="cuda", source=f"unispeech_tpu_torch/csrc/{fwd_src}",
            replaces="unispeech_tpu/ops/pallas/flash_attention.py:217",
            launches=n, max_abs_err=err,
            ms=n * cuda_ms(lambda: flash_attention.fused_attention(q, kk, v, **kw)),
            device_ms=n * device_ms(lambda: flash_attention.fused_attention(q, kk, v, **kw)),
            plain_ms=n * cuda_ms(lambda: flash_attention.fused_attention_plain(q, kk, v, **kw),
                                 iters=2, warmup=1),
            bound_ms=n * f_bound[0], bound_by=f_bound[1],
            **library_row(lambda: F.scaled_dot_product_attention(
                qh.detach(), kh.detach(), vh.detach(), attn_mask=attend, dropout_p=dropout_p), n))

    # bf16: row 1X carries the dropout forward's error too; fp32: row 1dfX
    rows = [forward_row(f"{pre_}fused_attention.nobias.hd{hd}.h{H}.padded_{path}", n_fwd, fwd,
                        err_f if f32 else max(err_f, err_d), 0.0)]
    if f32:
        rows.append(forward_row(f"fp32.fused_attention.dropout.nobias.hd{hd}.h{H}.padded_{path}",
                                n_drop, drop, err_d, rate))
    rows.append(dict(
        name=f"{pre_}fused_attention_backward.nobias.hd{hd}.h{H}.padded_{path}", route="cuda",
        source=f"unispeech_tpu_torch/csrc/{bwd_src}",
        replaces="unispeech_tpu/ops/pallas/flash_attention.py:583",
        launches=xl["counts"]["unfrozen"][5], max_abs_err=err_b,
        ms=n_bwd * cuda_ms(lambda: flash_attention.fused_attention_backward(*args)),
        device_ms=n_bwd * device_ms(lambda: flash_attention.fused_attention_backward(*args)),
        plain_ms=n_bwd * cuda_ms(lambda: flash_attention.fused_attention_backward_plain(*args),
                                 iters=2, warmup=1),
        bound_ms=n_bwd * b_bound[0], bound_by=b_bound[1],
        **library_row(grad_fn(ya, (qh, kh, vh), dout.transpose(1, 2).contiguous()), n_bwd)))
    return rows


def xlarge_cli_phase(counters, tmp):
    """xlarge (c): train finetune-ctc --arch large --encoder-json
    XLARGE_JSON on the pipeline's 12 files and ctc_pipeline's letter
    transcripts, 2 updates (the first frozen), --export-params; then decode
    --arch large --encoder-json XLARGE_JSON --decoder viterbi of that export
    (the CLIs' main(argv) in-process): finite losses, launches (an
    attention backward in update 2 only, no L1 or conv backward), one
    hypothesis per file, the WER report. The loop's final checkpoint (the
    full state, AdamW's moments too) is removed as soon as the run ends."""
    from unispeech_tpu_torch.decode.__main__ import main as decode_main
    from unispeech_tpu_torch.train.__main__ import main as train_main

    man = str(tmp / "man" / "train.tsv")
    ltr = str(tmp / "train.ltr")
    n_files = len(pathlib.Path(man).read_text().splitlines()) - 1
    ckpt, export = tmp / "xl_ckpt", tmp / "xl.npz"
    argv = ["finetune-ctc", "--manifest", man, "--transcripts", ltr, "--arch", "large",
            "--encoder-json", XLARGE_JSON, "--freeze-finetune-updates", "1",
            "--max-updates", "2", "--log-interval", "1", "--lr", "5e-5", "--warmup-steps", "2",
            "--save-interval-updates", "1000", "--checkpoint-dir", str(ckpt),
            "--export-params", str(export)]
    for m, attr in counters:
        setattr(m, attr, 0)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        train_main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    counts = tuple(getattr(m, attr) for m, attr in counters)
    train = [json.loads(x) for x in log.getvalue().splitlines()
             if x.startswith('{"tag": "train"')]
    for r in train:
        phase("xlarge_cli", update=r["step"], wall_s=r["elapsed_s"], loss=r["loss_avg"],
              ntokens=r.get("ntokens"))
    phase("xlarge_cli", step="finetune-ctc --max-updates 2", seconds=f"{train_s:.2f}",
          export_gb=f"{export.stat().st_size / 1e9:.2f}", launches_l1_conv_attn_fwd_bwd=counts)
    if [r["step"] for r in train] != [1, 2] or \
            not all(np.isfinite(r["loss_avg"]) for r in train):
        fail(f"xlarge_cli: finetune-ctc records {train}")
    if counts[1] or counts[3] or not (counts[0] and counts[2] and counts[4] and counts[5]):
        fail(f"xlarge_cli: finetune-ctc launches {counts}")

    out = tmp / "xl_decode"
    for m, attr in counters:
        setattr(m, attr, 0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        decode_main(["--manifest", man, "--transcripts", ltr, "--arch", "large",
                     "--encoder-json", XLARGE_JSON, "--checkpoint", str(export),
                     "--decoder", "viterbi", "--results-path", str(out)])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    export.unlink()
    counts = tuple(getattr(m, attr) for m, attr in counters)
    rep = json.loads((out / "wer_report.json").read_text())
    hyps = (out / "hypo.word").read_text().splitlines()
    phase("xlarge_cli", decode="viterbi", seconds=f"{decode_s:.2f}",
          utterances=rep.get("utterances"), wer=rep.get("wer"), uer=rep.get("uer"),
          hypo_lines=len(hyps), launches_l1_conv_attn_fwd_bwd=counts)
    if not {"utterances", "wer", "uer"} <= set(rep) or rep["utterances"] != n_files \
            or len(hyps) != n_files:
        fail(f"xlarge_cli: decode report {rep}, {len(hyps)} hypothesis lines")
    if not (counts[0] and counts[2] and counts[4]) or counts[1] or counts[3] or counts[5]:
        fail(f"xlarge_cli: decode launches {counts}")
    return dict(train_s=train_s, decode_s=decode_s)


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


def contrastive_setup(dev, tag, wav, lengths):
    """The model (bf16, seed 0), its config, the batch, the loss and the
    steps' generator of w2v_train (UniSpeech) or sat_train (UniSpeech-SAT)
    on the padded smoke batch: random letter transcripts at 15 symbols per
    second, or random frame labels."""
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel

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
    else:
        cfg = sat_large_config()
        model = HubertPretrainModel(cfg, dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(SEED))
        T = cfg.encoder.num_frames(wav.shape[1])
        batch["targets"] = torch.randint(0, N_CLASSES, (B, T, 1), generator=gen).to(dev)
    return cfg, model, batch, contrastive_loss_fn(model, w2v), gen


def contrastive_loss_fn(model, w2v: bool):
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn, make_wav2vec2_loss_fn

    return (make_wav2vec2_loss_fn(model, mtlalpha=0.5) if w2v else
            make_hubert_loss_fn(model, HubertCriterionConfig(spk_loss_weight=0.1)))


def contrastive_grads(m, w2v: bool, batch, step_no, seed: int):
    """fp32 copies of every parameter's gradient of one contrastive step's
    loss (per sample) with the step's randomness drawn from ``seed``."""
    m.zero_grad(set_to_none=True)
    loss, ss, _ = contrastive_loss_fn(m, w2v)(batch, torch.Generator().manual_seed(seed),
                                              step_no)
    (loss / torch.clamp(ss, min=1.0)).backward()
    out = [torch.zeros_like(p) if p.grad is None else p.grad.float().clone()
           for p in m.parameters()]
    m.zero_grad(set_to_none=True)
    return out


def contrastive_draws(model, model32, w2v: bool, batch, step_no, seeds):
    """Per draw (one generator seed each), per tensor: |gk - gp|^2, |gp|^2,
    |gk - g32|^2, |gp - g32|^2 of the kernel path (gk), the plain path (gp)
    and the plain path of the fp32 copy (g32), the codeword choices pinned
    to the kernel path's; and the counts of pinned and flipped choices."""
    per_draw = []
    n_pinned = n_flips = 0
    for seed in seeds:
        picks, flips = [], []
        with pinned_codewords(picks, flips):
            gk = contrastive_grads(model, w2v, batch, step_no, seed)
        with pinned_codewords(picks, flips), plain_ops():
            gp = contrastive_grads(model, w2v, batch, step_no, seed)
        with pinned_codewords(picks, flips), plain_ops():
            g32 = contrastive_grads(model32, w2v, batch, step_no, seed)
        per_draw.append(torch.stack([
            torch.stack([((a - b) ** 2).sum(), (b * b).sum(), ((a - c) ** 2).sum(),
                         ((b - c) ** 2).sum()])
            for a, b, c in zip(gk, gp, g32)], 1).double().cpu())
        n_pinned += sum(int(p.numel()) for p in picks)
        n_flips += sum(flips)
        del gk, gp, g32
    return per_draw, n_pinned, n_flips


def contrastive_worst(per_draw, names):
    """The gate over the draws stacked, per tensor, worst first: (the lesser
    of its ratios to train's rule and to the fp32 rule, its ratio to
    train's rule, name, relative L2 of gk to gp, |gk - g32|, |gp - g32|,
    index); and the global gradient norm."""
    diff, ref, err_k, err_p = sum(per_draw).sqrt().tolist()
    total = math.sqrt(sum(r * r for r in ref))
    worst = []
    for j, name in enumerate(names):
        rule = diff[j] / (GRAD_TOL * ref[j] + GRAD_FLOOR * total)
        vs32 = err_k[j] / (1.5 * err_p[j] + GRAD_FLOOR * total)
        worst.append((min(rule, vs32), rule, name, diff[j] / max(ref[j], 1e-30), err_k[j],
                      err_p[j], j))
    worst.sort(reverse=True)
    return worst, total


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
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step

    w2v = tag == "w2v_train"
    B = wav.shape[0]
    cfg, model, batch, loss_fn, gen = contrastive_setup(dev, tag, wav, lengths)
    enc = cfg.encoder
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
    model32 = type(model)(cfg).to(dev)
    model32.load_state_dict(model.state_dict())
    per_draw, n_pinned, n_flips = contrastive_draws(
        model, model32, w2v, batch, state.step, [SEED + 24 + d for d in range(GRAD_DRAWS)])
    del model32
    worst, total = contrastive_worst(per_draw, [n for n, _ in model.named_parameters()])
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


# the speaker workload: verification trials and diarized recordings
SPK_FILES, SPK_SECONDS, SPK_TRIALS, SPK_VOICES = 24, (3.0, 20.0), 48, 6
DIARIZE_SECONDS = (30, 90, 240)  # 240 s: a CALLHOME-length recording, T = 11,999
CALLHOME_ROWS = 256  # query rows held at each end of its attention
FWD_COUNTERS = ("l1_frontend", "conv_stack", "flash_attention")
# kernels rows of the speaker path: (index in a Large forward's launch
# counts, index in a Base+ forward's)
SPEAKER_ROWS = {"l1_conv_with_stats": (None, 0), "l1_conv_with_stats.no_sums": (0, None),
                "conv_gelu_block": (1, 1), "fused_attention": (2, 2)}


def voice(rng, v: int, n: int) -> np.ndarray:
    """n samples of synthetic speaker v: a harmonic series on its own pitch
    at a syllable-rate loudness, over noise low-passed per speaker."""
    t = np.arange(n) / SAMPLE_RATE
    f0 = 90.0 + 35.0 * v
    tone = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)) / h
               for h in range(1, 6))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * (2.5 + 0.5 * (v % 3)) * t) ** 2
    noise = np.convolve(rng.standard_normal(n), np.ones(v + 1) / (v + 1), "same")
    return 0.15 * tone * env + 0.05 * noise


def forward_counters():
    import importlib

    return [importlib.import_module(f"unispeech_tpu_torch.ops.kernels.{m}") for m in FWD_COUNTERS]


def launch_counts():
    return tuple(m.launches for m in forward_counters())


def reset_launches():
    for m in forward_counters():
        m.launches = 0


def convert_phase(tmp):
    """convert: WavLM-Large as verification --arch large builds it (seed 0)
    through a reference .pt and back (strict load, every tensor equal); a
    fairseq CTC checkpoint of that backbone (w2v_encoder.w2v_model.) through
    ctc_state_dict_from_fairseq and strip_w2v_prefix; then the .npz files
    the speaker CLIs read: the Large and Base+ backbones in the JAX layout,
    seed-0 ECAPA heads for both and a seed-0 diarization head."""
    from unispeech_tpu_torch.configs import WavLMModelConfig
    from unispeech_tpu_torch.convert import fairseq
    from unispeech_tpu_torch.convert.from_jax import (
        jax_params_from_state_dict,
        jax_params_of,
        save_params_npz,
    )
    from unispeech_tpu_torch.downstream.diarization import DiarizationConfig, TransformerDiarization
    from unispeech_tpu_torch.downstream.ecapa_tdnn import EcapaConfig, EcapaTdnn
    from unispeech_tpu_torch.downstream.verification import encoder_config
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel
    from unispeech_tpu_torch.models.wavlm import WavLM

    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    enc = encoder_config("large")
    model = WavLM(WavLMModelConfig(encoder=enc), generator=torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    nparams = sum(v.numel() for v in sd.values())

    ref_cfg = {"encoder_layers": enc.encoder_layers, "encoder_embed_dim": enc.encoder_embed_dim}

    def roundtrip(name, ref_sd, importer, want):
        """write ref_sd as a reference .pt, read it back and import it: the
        keys and every tensor of ``want``."""
        path = tmp / name
        t0 = time.perf_counter()
        fairseq.save_reference_checkpoint(str(path), ref_sd, cfg=ref_cfg)
        back, cfg = fairseq.load_reference_checkpoint(str(path))
        got = importer(back)
        seconds = time.perf_counter() - t0
        unequal = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        phase("convert", checkpoint=name, tensors=len(got), mbytes=path.stat().st_size >> 20,
              seconds=f"{seconds:.2f}", unequal=len(unequal))
        if unequal or sorted(got) != sorted(want) or cfg != ref_cfg:
            fail(f"convert: {name} changed on the way: {unequal[:5]}")
        path.unlink()
        return got

    got = roundtrip("WavLM-Large.pt", sd,
                    lambda s: fairseq.wavlm_state_dict_from_reference(s, enc), sd)
    model.load_state_dict(got, strict=True)
    gen = torch.Generator().manual_seed(SEED + 30)
    proj = {"weight": torch.randn(32, enc.encoder_embed_dim, generator=gen) * 0.02,
            "bias": torch.zeros(32)}
    ctc_sd = {"wavlm." + k: v for k, v in sd.items()}
    ctc_sd.update({"proj." + k: v for k, v in proj.items()})
    ctc_cfg = CtcFinetuneConfig(encoder=enc, vocab_size=32)
    ref = fairseq.ctc_to_fairseq(ctc_sd, ctc_cfg)
    if not all(k.startswith("w2v_encoder.") for k in ref):
        fail("convert: a CTC key outside w2v_encoder.")
    got = roundtrip("ctc-large.pt", ref, lambda s: fairseq.ctc_state_dict_from_fairseq(s, enc),
                    ctc_sd)
    with torch.device("meta"):
        ctc = CtcFinetuneModel(ctc_cfg)
    ctc.load_state_dict(got, strict=True, assign=True)
    warm = fairseq.backbone_state_dict_from_fairseq(fairseq.strip_w2v_prefix(ref), enc)
    if sorted(warm) != sorted(sd) or not all(torch.equal(warm[k], sd[k]) for k in sd):
        fail("convert: the stripped CTC backbone differs from the WavLM")
    del ctc, got, warm, ref, ctc_sd

    t0 = time.perf_counter()
    files = {"large": tmp / "large.npz", "base": tmp / "base.npz",
             "ecapa_large": tmp / "ecapa_large.npz", "ecapa_base": tmp / "ecapa_base.npz",
             "diarization": tmp / "diarization.npz"}
    save_params_npz(str(files["large"]), jax_params_from_state_dict(sd, enc))
    del model, sd
    base_enc = encoder_config("base")
    base = WavLM(WavLMModelConfig(encoder=base_enc), generator=torch.Generator().manual_seed(SEED))
    save_params_npz(str(files["base"]), jax_params_from_state_dict(base.state_dict(), base_enc))
    for name, e in (("ecapa_large", enc), ("ecapa_base", base_enc)):
        head = EcapaTdnn(EcapaConfig(num_layer_feats=e.encoder_layers + 1), e.encoder_embed_dim,
                         generator=torch.Generator().manual_seed(SEED))
        save_params_npz(str(files[name]), jax_params_of(head))
    head = TransformerDiarization(DiarizationConfig(), enc.encoder_embed_dim,
                                  generator=torch.Generator().manual_seed(SEED))
    save_params_npz(str(files["diarization"]), jax_params_of(head))
    phase("convert", params=nparams, npz_seconds=f"{time.perf_counter() - t0:.2f}",
          **{f"{k}_mbytes": v.stat().st_size >> 20 for k, v in files.items()})
    return files


@contextlib.contextmanager
def hooked(module, name, record):
    """Wrap ``module.name`` so each call resets the forward launch counters,
    is timed to a synchronised end and appends (launches, seconds, args,
    result) to ``record``."""
    orig = getattr(module, name)

    def wrapper(*args):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args)
        torch.cuda.synchronize()
        record.append((launch_counts(), time.perf_counter() - t0, args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def reset_peak() -> float:
    """Reset the peak-memory counter; returns the GB allocated now, which a
    CLI's peak is reported above (the earlier phases' tensors)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def head_on_cpu(head, *inputs):
    """The same head (a copy of its weights) run on the CPU, fp32."""
    import copy

    cpu = copy.deepcopy(head).cpu()
    with torch.no_grad():
        return cpu(*(None if x is None else x.cpu() for x in inputs))


def card_vs_cpu(tag, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |card - CPU| over the CPU output's scale, held at 1e-4."""
    got, want = got.float().cpu(), want.float()
    err = float((got - want).abs().max() / want.abs().max())
    phase(tag, head_card_vs_cpu_max_err_over_scale=f"{err:.3g}", tol="1e-4")
    if not (torch.isfinite(got).all() and err <= 1e-4):
        fail(f"{tag}: the head on the card disagrees with the CPU: {err}")
    return err


def alone_vs_batch(tag, dev, backbone, head, src, lengths, emb):
    """The most padded row of a verification batch embedded alone against
    its row in the batch. Held: every layer's output on the valid frames
    within rel L2 5e-2 (key padding in the attention kernel); the batch's
    embeddings unchanged, within 1e-5, when its padded frames hold 99
    instead of the backbone's values (the head's masking). Printed: the
    embedding of the alone run's layer outputs zero-padded to the batch's
    length against the batch row's, and of the file alone unpadded (its
    head sees a shorter time axis: the squeeze-excitation means and the
    convs at the last valid frames run over the padded frames too, as in
    JAX); both carry the layers' bf16 differences through the random head.
    Only WavLM-Large's frontend is per frame: Base+'s GroupNorm normalises
    over the padded length, as the reference's does."""
    from unispeech_tpu_torch.downstream import verification

    r = int(lengths.argmin())
    n = int(lengths[r])
    alone_src = torch.zeros(1, -(-n // 320) * 320, device=dev)
    alone_src[0, :n] = src[r, :n]
    with torch.no_grad():
        batch = backbone(src, lengths=lengths, collect_layer_outputs=True)
        lay, pm = batch.layer_outputs, batch.padding_mask
        lay_a = backbone(alone_src, lengths=lengths[r:r + 1],
                         collect_layer_outputs=True).layer_outputs
        t = lay_a.shape[2]
        e_lay = max(rel_l2(lay_a[i, 0], lay[i, r, :t]) for i in range(lay_a.shape[0]))
        e_garbage = rel_l2(head(lay.masked_fill(pm[None, ..., None], 99.0), pm), head(lay, pm))
        padded = torch.zeros_like(lay[:, r:r + 1])
        padded[:, :, :t] = lay_a
        e_padded = rel_l2(head(padded, pm[r:r + 1]), head(lay[:, r:r + 1], pm[r:r + 1]))
    alone = verification.embed_batch(backbone, head, alone_src, lengths[r:r + 1])[0]
    e = float(np.linalg.norm(alone - emb[r]) / np.linalg.norm(alone))
    phase(tag, valid_share=f"{n / src.shape[1]:.3f}", alone_vs_batch_layers_rel_l2=f"{e_lay:.3g}",
          tol="5e-2", padded_frames_99_vs_backbone_rel_l2=f"{e_garbage:.3g}", tol_masking="1e-5",
          alone_padded_vs_batch_embedding_rel_l2=f"{e_padded:.3g}",
          alone_unpadded_vs_batch_embedding_rel_l2=f"{e:.3g}")
    if not (e_lay <= 5e-2 and e_garbage <= 1e-5):
        fail(f"{tag}: a file alone disagrees with its padded batch row ({e_lay}), or the "
             f"head reads padded frames ({e_garbage})")
    return dict(layers=e_lay, masking=e_garbage, padded=e_padded, unpadded=e)


def verification_run(dev, tmp, files, arch, want_launches):
    """One ``verification`` CLI call in-process on the speaker files; the
    per-batch launch counts and the card-side checks. Returns its row."""
    from unispeech_tpu_torch.downstream import verification

    argv = ["--trials", str(tmp / "trials.txt"), "--wav-root", str(tmp / "spk"),
            "--backbone", str(files[arch]), "--head", str(files[f"ecapa_{arch}"]),
            "--arch", arch, "--batch-size", "8", "--scores-path", str(tmp / f"scores_{arch}.txt"),
            "--device", str(dev)]
    batches = []
    out = io.StringIO()
    base_gb = reset_peak()
    t0 = time.perf_counter()
    with hooked(verification, "embed_batch", batches), contextlib.redirect_stdout(out):
        verification.main(argv)
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    tag = f"verification_{arch}"
    for counts, s, args, _ in batches:
        phase(tag, batch_shape=tuple(args[2].shape), launches=counts, seconds=f"{s:.3f}")
    if any(c != want_launches for c, *_ in batches):
        fail(f"{tag}: launches per batch forward {[c for c, *_ in batches]} != {want_launches}")
    rows = [line.split() for line in (tmp / f"scores_{arch}.txt").read_text().splitlines()]
    scores = np.asarray([float(r[0]) for r in rows])
    same = np.asarray([r[2] == r[3] for r in rows])
    audio_s = sum(float(a[3].sum()) for _, _, a, _ in batches) / SAMPLE_RATE
    embed_s = sum(s for _, s, _, _ in batches)
    phase(tag, report=json.dumps(report).replace(" ", ""), trials=len(rows),
          seconds_per_call=f"{seconds:.2f}", trials_per_s=f"{len(rows) / seconds:.1f}",
          embed_seconds=f"{embed_s:.3f}", audio_sec_per_s_embed=f"{audio_s / embed_s:.1f}",
          peak_memory_gb_above_start=f"{peak_gb:.2f}", allocated_at_start_gb=f"{base_gb:.2f}",
          min_same_file_score=f"{scores[same].min():.5f}")
    if (report["trials"] != SPK_TRIALS or len(rows) != SPK_TRIALS
            or not np.isfinite(scores).all() or not np.isfinite(report["eer"])):
        fail(f"{tag}: not every trial scored, or a non-finite score")
    if not scores[same].min() >= 0.999:
        fail(f"{tag}: a file scored against itself gave {scores[same].min()}")

    _, _, (backbone, head, src, lengths), emb = batches[0]
    padding = alone_vs_batch(tag, dev, backbone, head, src, lengths, emb) if arch == "large" else None
    # the ECAPA head on the card against the CPU, the same layer features
    with torch.no_grad():
        feats = backbone(src, lengths=lengths, collect_layer_outputs=True)
        got = head(feats.layer_outputs, feats.padding_mask)
    err = card_vs_cpu(tag, got, head_on_cpu(head, feats.layer_outputs.float(), feats.padding_mask))
    return dict(seconds=seconds, trials_per_s=len(rows) / seconds, peak_gb=peak_gb,
                eer=report["eer"], launches=batches[0][0], head_err=err, padding=padding)


def speaker_phase(dev, tmp, files):
    """speaker: the verification CLI at --arch large and --arch base on 24
    synthesised files of 3-20 s (6 speakers) and 48 trials, and the diarize
    CLI --arch large on recordings of 30, 90 and 240 s against a reference
    RTTM; the attention kernel at the 240 s length, the 90 s backbone's
    kernel path against its plain path, both heads card against CPU."""
    from unispeech_tpu_torch.convert.from_jax import (
        diarization_state_dict_from_jax,
        load_params_npz,
    )
    from unispeech_tpu_torch.downstream import diarize
    from unispeech_tpu_torch.downstream.diarization import (
        DiarizationConfig,
        TransformerDiarization,
        compute_der,
        parse_rttm,
    )
    from unispeech_tpu_torch.downstream.verification import encoder_config
    from unispeech_tpu_torch.models import encoder as encoder_mod
    from unispeech_tpu_torch.ops.kernels import flash_attention

    rng = np.random.default_rng(SEED + 31)
    (tmp / "spk").mkdir()
    names = []
    for i in range(SPK_FILES):
        n = int(rng.uniform(*SPK_SECONDS) * SAMPLE_RATE)
        names.append(f"s{i % SPK_VOICES}_{i:02d}.wav")
        write_wav(tmp / "spk" / names[-1], voice(rng, i % SPK_VOICES, n))
    half = SPK_TRIALS // 2
    pairs = [(1, a, a) for a in names[:half]]
    while len(pairs) < SPK_TRIALS:  # different files, half of one speaker
        a, b = rng.choice(names, 2, replace=False)
        pairs.append((int(a[:2] == b[:2]), a, b))
    (tmp / "trials.txt").write_text("".join(f"{l} {a} {b}\n" for l, a, b in pairs))
    large = encoder_config("large")
    want_large = (1, 2 * (len(large.conv_layers) - 1), large.encoder_layers)
    ver = {"large": verification_run(dev, tmp, files, "large", want_large),
           "base": verification_run(dev, tmp, files, "base", (1, 7, 12))}

    # diarization: recordings of 2-3 speakers in turns of 2-8 s
    (tmp / "rec").mkdir()
    rows, ref = [], []
    for i, seconds in enumerate(DIARIZE_SECONDS):
        n_spk, t, parts = 2 + i % 2, 0.0, []
        while t < seconds:
            d = min(rng.uniform(2.0, 8.0), seconds - t)
            spk = len(parts) % n_spk
            parts.append(voice(rng, spk, int(round(d * SAMPLE_RATE))))
            ref.append(f"SPEAKER rec{i} 1 {t:.3f} {d:.3f} <NA> <NA> v{spk} <NA> <NA>")
            t += d
        wav = np.concatenate(parts)
        write_wav(tmp / "rec" / f"rec{i}.wav", wav)
        rows.append(f"rec{i}.wav\t{len(wav)}")
    (tmp / "rec.tsv").write_text(f"{tmp / 'rec'}\n" + "\n".join(rows) + "\n")
    (tmp / "ref.rttm").write_text("\n".join(ref) + "\n")
    argv = ["--manifest", str(tmp / "rec.tsv"), "--backbone", str(files["large"]),
            "--head", str(files["diarization"]), "--arch", "large", "--rttm-dir",
            str(tmp / "rttm"), "--ref-rttm", str(tmp / "ref.rttm"), "--device", str(dev)]
    recs, infer_fns = [], []
    first_layer = {}  # T -> the first layer's attention arguments
    out = io.StringIO()
    orig_attention, orig_chunked = encoder_mod.fused_attention, diarize.chunked_diarization

    def chunked(infer_fn, feats, **kw):  # keeps the CLI's head on the card
        infer_fns.append(infer_fn)
        return orig_chunked(infer_fn, feats, **kw)

    def first_layer_attention(*args, **kw):
        # kept for the longest recording: its first layer's q, k, v, bias, gate
        if launch_counts()[2] == 0 and args[0].shape[1] > max(first_layer, default=0):
            first_layer.clear()
            first_layer[args[0].shape[1]] = (args, kw)
        return orig_attention(*args, **kw)

    base_gb = reset_peak()
    t0 = time.perf_counter()
    encoder_mod.fused_attention = first_layer_attention
    diarize.chunked_diarization = chunked
    try:
        with hooked(diarize, "recording_features", recs), contextlib.redirect_stdout(out):
            diarize.main(argv)
    finally:
        encoder_mod.fused_attention = orig_attention
        diarize.chunked_diarization = orig_chunked
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    ref_all = (tmp / "ref.rttm").read_text()
    for i, (counts, s, args, feats) in enumerate(recs):
        n = int(rows[i].split("\t")[1])
        rttm = (tmp / "rttm" / f"rec{i}.rttm").read_text()
        segs = parse_rttm(rttm)
        ref_i = "\n".join(l for l in ref_all.splitlines() if f" rec{i} " in l)
        der = compute_der(ref_i, rttm)["der"]
        want_frames = large.num_frames(-(-n // 320) * 320)  # = ceil(n / 320) - 1
        phase("diarize", recording=f"rec{i}", seconds_audio=f"{n / SAMPLE_RATE:.1f}",
              frames=feats.shape[0], forward_seconds=f"{s:.3f}", launches=counts,
              speakers=len({sp for *_, sp in segs}), segments=len(segs), der=f"{der:.4f}")
        if counts != want_large:
            fail(f"diarize: rec{i} launches {counts} != {want_large}")
        if feats.shape[0] != want_frames or not np.isfinite(feats).all():
            fail(f"diarize: rec{i} frames {feats.shape[0]} != {want_frames} or not finite")
        if not segs or max(st + d for _, st, d, _ in segs) > feats.shape[0] * 0.02 + 1e-6:
            fail(f"diarize: rec{i}: no segment, or one past the recording")
    phase("diarize", report=json.dumps(report).replace(" ", ""), seconds_per_call=f"{seconds:.2f}",
          peak_memory_gb_above_start=f"{peak_gb:.2f}", allocated_at_start_gb=f"{base_gb:.2f}")
    if report["recordings"] != len(DIARIZE_SECONDS) or not np.isfinite(report.get("der", np.nan)):
        fail(f"diarize: report {report}")

    # the attention kernel at the 240 s length (H T S > 2^31 bias elements):
    # the first and last 256 query rows against all keys, by the parity rule
    (q, k, v, bias, gate, kpm), kw = first_layer.popitem()[1]
    T = q.shape[1]
    out_k = flash_attention.fused_attention(q, k, v, bias, gate, kpm, **kw)
    err_callhome = 0.0
    for name, rows_ in (("first", slice(0, CALLHOME_ROWS)), ("last", slice(T - CALLHOME_ROWS, T))):
        plain = flash_attention.fused_attention_plain(
            q[:, rows_], k, v, bias[:, rows_], None if gate is None else gate[:, :, rows_], kpm)
        err_callhome = max(err_callhome, compare(
            f"fused_attention.T{T}.{name}_{CALLHOME_ROWS}_rows", out_k[:, rows_], plain))
    phase("diarize", callhome_T=T, bias_elements=bias.numel(), over_2_31=bias.numel() > 2 ** 31)
    del q, k, v, bias, gate, out_k, plain

    # the 90 s recording's whole backbone: kernel path against plain path,
    # and the diarization head card against CPU on its first chunk
    _, _, (backbone, wav, _), feats = recs[1]
    n = -(-len(wav) // 320) * 320
    src = torch.zeros(1, n, device=dev)
    src[0, :len(wav)] = torch.from_numpy(wav).to(dev)
    with torch.no_grad():
        x = backbone(src).x
        with plain_ops():
            px = backbone(src).x
    e90 = rel_l2(x, px)
    phase("diarize", rec1_T=x.shape[1], rel_l2_vs_plain=f"{e90:.3g}", tol="5e-2",
          rel_l2_vs_cli=f"{rel_l2(x[0].float().cpu(), torch.from_numpy(feats)):.3g}")
    if not e90 <= 5e-2:
        fail("diarize: the 90 s backbone's kernel path disagrees with its plain path")
    del x, px
    # the CLI's head on the card against the same .npz's head on the CPU
    head = TransformerDiarization(DiarizationConfig(), large.encoder_embed_dim)
    head.load_state_dict(diarization_state_dict_from_jax(load_params_npz(str(files["diarization"]))),
                         strict=True)
    logits, spk = infer_fns[1](feats[:2000])
    want = head_on_cpu(head.eval(), torch.from_numpy(feats[:2000])[None])
    dia_err = max(card_vs_cpu("diarize", torch.from_numpy(logits), want.logits[0]),
                  card_vs_cpu("diarize", torch.from_numpy(spk), want.spk_vectors[0]))
    return dict(ver=ver, diarize_seconds=seconds, diarize_peak_gb=peak_gb, der=report["der"],
                recs=[(c, s, f.shape[0]) for c, s, _, f in recs], err_callhome=err_callhome,
                e90=e90, dia_err=dia_err)


# the fp32 phase's gates: the 3xTF32 products are fp32 to a few ulps, summed
# in another order than the plain fp32 versions (TF32 off); one TF32 pass
# (~1e-3 relative) or a bf16 rounding (~4e-3) fails them
F32_REL_L2, F32_MAX_OF_SCALE = 1e-5, 1e-4
# the fp32 features, kernel path against plain path through 12 or 24 layers
F32_MODEL_REL_L2 = 1e-4
# a query row whose open keys all sit behind a -1e4 (T, S) mask has logits
# near -1e4, where one fp32 ulp is 2^-10: the kernel and the plain version
# each round them to half an ulp, so the last bits of S flip p there by up
# to an ulp (tests/test_torch_attn_fwd_f32_mid_layout.py); other rows take
# F32_REL_L2
F32_BEHIND_MASK_REL_L2 = 2.0 ** -10


def f32_check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """An fp32 kernel's output against its plain version: relative L2 <=
    1e-5 and max |got - want| <= 1e-4 max |want|. Returns the max abs error."""
    if got.dtype != torch.float32 or got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"fp32 {name}: {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}, or non-finite")
    diff = got - want
    rel, err = float(diff.norm() / want.norm()), float(diff.abs().max())
    scale = float(want.abs().max())
    phase("fp32", parity=name, rel_l2=f"{rel:.3g}", max_abs_err=f"{err:.3g}",
          max_abs_over_max_plain=f"{err / scale:.3g}",
          tol=f"rel_l2<={F32_REL_L2},max_abs<={F32_MAX_OF_SCALE}*max|plain|")
    if not (rel <= F32_REL_L2 and err <= F32_MAX_OF_SCALE * scale):
        fail(f"fp32 {name}: relative L2 {rel}, max abs {err} of {scale}")
    return err


def fp32_phase(dev, wav, lengths, base_cfg, card, tmp):
    """Feature extraction at the models' default dtype (fp32): (a) each fp32
    kernel against its plain version at the serving shapes, with a row of
    length 0; (b) WavLM-Base+ and WavLM-Large built without a dtype (Large
    through a reference-layout .pt), extract_features on the smoke batch:
    launches, fp32 and finite, against the plain path; (c) each fp32
    kernel's times, bound, plain and library call, the forwards' ms,
    audio-s/s and peak memory. Returns the kernels rows and the forwards'
    launches, ms and peak memory."""
    from unispeech_tpu_torch.configs import WavLMModelConfig, large_encoder_config
    from unispeech_tpu_torch.convert import fairseq
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.ops.kernels import (
        TF32_TC_FLOPS,
        conv_stack,
        flash_attention,
        l1_frontend,
    )
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    f32 = torch.float32
    B, NS = wav.shape
    gen = torch.Generator().manual_seed(SEED + 40)
    C, k0, s0 = base_cfg.conv_layers[0]
    w1 = (torch.randn(k0, 1, C, generator=gen) * (2.0 / k0) ** 0.5).to(dev)
    wav0 = wav.clone()
    wav0[-1] = 0.0  # a row of length 0
    err = {}

    # (a) L1 with and without its sums: rtol 1e-5 / atol 1e-6 (the JAX
    # test's); the sums within 1e-5 of the sum of |terms| (fp32 atomics in a
    # varying order over 51,199 rows)
    for stats in (True, False):
        tag = "l1" if stats else "l1.no_sums"
        before = l1_frontend.launches
        y, s1, s2, t1 = l1_frontend.l1_conv_with_stats(wav0, w1, s0, dtype=f32, with_stats=stats)
        py, ps1, ps2, _ = l1_frontend.l1_conv_with_stats_plain(wav0, w1, s0, f32)
        torch.cuda.synchronize()
        if l1_frontend.launches != before + 1 or y.dtype != f32 or not torch.isfinite(y).all():
            fail(f"fp32 {tag}: {l1_frontend.launches - before} launches, {y.dtype}")
        over = float(((y - py).abs() - (1e-6 + 1e-5 * py.abs())).max())
        err[tag] = float((y - py).abs().max())
        phase("fp32", parity=f"{tag}.y1", max_abs_err=f"{err[tag]:.3g}",
              rel_l2=f"{rel_l2(y, py):.3g}", worst_over_rtol_atol=f"{over:.3g}",
              tol="rtol_1e-5_atol_1e-6")
        if over > 0:
            fail(f"fp32 {tag}: y1 beyond rtol 1e-5 / atol 1e-6 by {over}")
        if stats:
            for nm, got, want, terms in (("s1", s1, ps1, py.abs().sum(1)),
                                         ("s2", s2, ps2, py.square().sum(1))):
                e = float(((got - want).abs() / terms.clamp_min(1e-30)).max())
                phase("fp32", parity=f"{tag}.{nm}", max_rel_to_sum_abs=f"{e:.3g}", tol="1e-5")
                if not e <= 1e-5:
                    fail(f"fp32 {tag}.{nm}: {e}")
        del y, s1, s2, py, ps1, ps2

    # the conv blocks in both extractors' forms at the serving shapes, the
    # frames of the length-0 row zero
    x0 = torch.randn(B, t1, C, generator=gen).to(dev)
    x0[-1] = 0.0
    affine = ((torch.rand(B, C, generator=gen) + 0.5).to(dev),
              (torch.randn(B, C, generator=gen) * 0.1).to(dev))
    conv_calls = []  # the Base+ form's blocks as the main path calls them
    err["conv"] = 0.0
    for form in ("default", "layer_norm"):
        x = x0
        for i, (dim, k, _) in enumerate(base_cfg.conv_layers[1:], start=2):
            w = (torch.randn(k, C, dim, generator=gen) * (2.0 / (k * C)) ** 0.5).to(dev)
            first = i == 2
            args = ((x, w, x.shape[1], first, True, affine if first else None)
                    if form == "default" else (x, w, x.shape[1], True, False, None))
            y, _ = conv_stack.conv_gelu_block(*args)
            py, _ = conv_stack.conv_gelu_block_plain(*args)
            torch.cuda.synchronize()
            err["conv"] = max(err["conv"], f32_check(f"conv_gelu_block.{form}.L{i}", y, py))
            if form == "default":
                conv_calls.append(args)
                x = py
            else:
                x = F.layer_norm(py, (dim,))
    del x0, y, py

    # attention at T = 799: Base+ (12 x 64), Large (16 x 64) and hd 80 (16
    # x 80, width 80), gated rel-pos bias, key padding with a row of length
    # 0; Base+ also with a (T, S) mask. lse on the rows with a key within
    # 1e-4 (plus 2 fp32 ulps of |lse|: a row whose unmasked keys are all
    # padded sits near the mask's -1e4)
    T = base_cfg.num_frames(NS)
    frames = torch.tensor([base_cfg.num_frames(int(n)) for n in lengths.cpu()], device=dev)
    frames0 = frames.clone()
    frames0[-1] = 0
    kpm0 = torch.arange(T, device=dev)[None, :] >= frames0[:, None]
    amask = torch.where((torch.arange(T)[:, None] - torch.arange(T)[None, :]).abs() > 200,
                        -1e4, 0.0).to(dev)
    attn = {}
    err["attn"] = err["attn.large"] = 0.0
    for tag, H, hd, extra in (("base", 12, 64, {}), ("base.attn_mask", 12, 64, {"attn_mask": amask}),
                              ("large", 16, 64, {}), ("hd80", 16, 80, {})):
        q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev) for _ in range(3))
        table = (torch.randn(base_cfg.num_buckets, H, generator=gen) * 0.5).to(dev)
        bias = compute_rel_pos_bias(table, T, T, base_cfg.num_buckets, base_cfg.max_distance,
                                    dtype=f32)
        gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
        a = (q, kk, v, bias, gate, kpm0)
        before = flash_attention.launches
        out, lse = flash_attention.fused_attention(*a, **extra, return_lse=True)
        pout, plse = flash_attention.fused_attention_plain(*a, **extra, return_lse=True)
        torch.cuda.synchronize()
        if flash_attention.launches != before + 1:
            fail(f"fp32 attention {tag}: {flash_attention.launches - before} launches")
        e = f32_check(f"fused_attention.{tag}", out, pout)
        err["attn.large" if tag == "large" else "attn"] = max(
            err["attn.large" if tag == "large" else "attn"], e)
        ok = frames0 > 0
        e_lse = float(((lse - plse)[ok].abs() - 2 * 2.0 ** -23 * plse[ok].abs()).max())
        phase("fp32", parity=f"fused_attention.{tag}.lse", max_abs_err_beyond_2ulp=f"{e_lse:.3g}",
              tol="1e-4")
        if not e_lse <= 1e-4:
            fail(f"fp32 attention {tag}: lse {e_lse}")
        # an all-padded row: uniform over its S keys, finite
        if not torch.allclose(out[-1], v[-1].mean(0, keepdim=True).expand_as(out[-1]),
                              rtol=1e-5, atol=1e-5):
            fail(f"fp32 attention {tag}: the row of length 0 is not uniform")
        if tag in ("base", "large"):
            kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
            attn[tag] = (q, kk, v, bias, gate, kpm)
    del out, pout, lse, plse

    # (b) the models at their default dtype
    counters = (l1_frontend, conv_stack, flash_attention)
    large_cfg = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                                     dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0)
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    e2e = {}
    try:
        for arch, enc, want in (("base_plus", base_cfg, (1, 7, 12)),
                                ("large", large_cfg, (1, 12, 24))):
            t0 = time.perf_counter()
            model = WavLM(WavLMModelConfig(encoder=enc),
                          generator=torch.Generator().manual_seed(SEED))
            if arch == "large":  # through the reference layout, as a user's checkpoint
                path = tmp / "WavLM-Large.pt"
                fairseq.save_reference_checkpoint(str(path), model.state_dict(),
                                                  cfg={"encoder_layers": enc.encoder_layers})
                sd, _ = fairseq.load_reference_checkpoint(str(path))
                path.unlink()
                with torch.device("meta"):
                    model = WavLM(WavLMModelConfig(encoder=enc))
                model.load_state_dict(fairseq.wavlm_state_dict_from_reference(sd, enc),
                                      strict=True, assign=True)
                del sd
            model = model.to(dev).eval()
            build_s = time.perf_counter() - t0
            if model.dtype != f32 or any(p.dtype != f32 for p in model.parameters()):
                fail(f"fp32 {arch}: the default model is not fp32")
            nparams = sum(p.numel() for p in model.parameters())
            for c in counters:
                c.launches = 0
            out = model.extract_features(wav, lengths=lengths).x
            torch.cuda.synchronize()
            launches = tuple(c.launches for c in counters)
            n_frames, D = enc.num_frames(NS), enc.encoder_embed_dim
            if out.dtype != f32 or out.shape != (B, n_frames, D) or not torch.isfinite(out).all():
                fail(f"fp32 {arch}: output {out.dtype} {tuple(out.shape)}, or non-finite")
            if launches != want:
                fail(f"fp32 {arch}: launches (l1, conv, attention) {launches} != {want}")
            with plain_ops():
                plain = model.extract_features(wav, lengths=lengths).x
            e = rel_l2(out, plain)
            del out, plain
            fwd_ms = cuda_ms(lambda: model.extract_features(wav, lengths=lengths), iters=5,
                             warmup=2)
            torch.cuda.synchronize()
            base_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            model.extract_features(wav, lengths=lengths)
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            audio_s = float(lengths.sum()) / SAMPLE_RATE
            phase("fp32", model=arch, params=nparams, build_s=f"{build_s:.1f}",
                  shape=(B, n_frames, D), dtype="float32", launches=launches,
                  rel_l2_vs_plain=f"{e:.3g}", tol=F32_MODEL_REL_L2,
                  forward_ms=f"{fwd_ms:.3f}", audio_seconds=audio_s,
                  audio_sec_per_s=f"{audio_s / (fwd_ms / 1e3):.1f}",
                  peak_memory_gb=f"{peak_gb:.2f}", held_before_gb=f"{base_gb:.2f}",
                  card=card.replace(" ", "_"))
            if not e <= F32_MODEL_REL_L2:
                fail(f"fp32 {arch}: kernel path against plain path {e}")
            e2e[arch] = dict(launches=launches, forward_ms=fwd_ms, peak_gb=peak_gb)
            del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) times at the serving shapes: per forward (all of a kernel's
    # launches); bounds from the bytes (fp32, each read and written once) and
    # the operations at the peak of the work's type: the L1 on the CUDA
    # cores (67 TFLOP/s), the products as 3xTF32 on the tensor cores (three
    # TF32 products each, 495 TFLOP/s)
    base_l, large_l = e2e["base_plus"]["launches"], e2e["large"]["launches"]
    src = "unispeech_tpu_torch/csrc/"
    rows = []
    wav_lib = wav[:, None, :]
    w1_lib = w1.permute(2, 1, 0).contiguous()
    t1 = (NS - k0) // s0 + 1
    l1_flops = 2 * B * t1 * C * k0
    for stats, n in ((True, base_l[0]), (False, large_l[0])):
        nbytes = B * NS * 4 + B * t1 * C * 4 + (2 * B * C * 4 if stats else 0)
        fn = lambda: l1_frontend.l1_conv_with_stats(wav, w1, s0, dtype=f32, with_stats=stats)
        b_ms, b_by = bound(nbytes, l1_flops, FP32_FLOPS)
        rows.append(dict(
            name="fp32.l1_conv_with_stats" + ("" if stats else ".no_sums"), route="cuda",
            source=src + "l1_frontend_f32.cu", replaces="unispeech_tpu/ops/pallas/l1_frontend.py:164",
            launches=n, max_abs_err=err["l1" if stats else "l1.no_sums"],
            ms=n * cuda_ms(fn), device_ms=n * device_ms(fn),
            plain_ms=n * cuda_ms(lambda: l1_frontend.l1_conv_with_stats_plain(
                wav, w1, s0, f32, stats), iters=5),
            bound_ms=n * b_ms, bound_by=b_by,
            **library_row(lambda: F.conv1d(wav_lib, w1_lib, stride=s0), n)))
    conv = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                library_device_ms=0.0)
    by = set()
    for args in conv_calls:
        x, w = args[0], args[1]
        kw = w.shape[0]
        t_out = (x.shape[1] - kw) // 2 + 1
        flops = 2 * B * t_out * C * kw * C
        b_ms, b_by = bound((B * x.shape[1] * C + kw * C * C + B * t_out * C) * 4, 3 * flops,
                           TF32_TC_FLOPS)
        one = device_ms(lambda: conv_stack.conv_gelu_block(*args))
        conv["ms"] += cuda_ms(lambda: conv_stack.conv_gelu_block(*args))
        conv["device_ms"] += one
        conv["plain_ms"] += cuda_ms(lambda: conv_stack.conv_gelu_block_plain(*args), iters=5)
        conv["bound_ms"] += b_ms
        by.add(b_by)
        xt, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        lib = library_times(lambda: F.conv1d(xt, wt, stride=2))
        conv["library_ms"] += lib[0]
        conv["library_device_ms"] += lib[1]
        phase("fp32", times=f"conv_gelu_block.T{x.shape[1]}", device_ms=f"{one:.4f}",
              bound_ms=f"{b_ms:.4f}", fp32_tflops=f"{flops / one / 1e9:.1f}",
              library_device_ms=f"{lib[1]:.4f}")
    rows.append(dict(name="fp32.conv_gelu_block", route="cuda", source=src + "conv_stack_f32.cu",
                     replaces="unispeech_tpu/ops/pallas/conv_stack.py:156", launches=base_l[1],
                     max_abs_err=err["conv"], bound_by="operations" if "operations" in by
                     else "bytes", **conv))
    for tag, n in (("base", base_l[2]), ("large", large_l[2])):
        q, kk, v, bias, gate, kpm = a = attn[tag]
        H, hd = q.shape[2], q.shape[3]
        nbytes = 4 * B * T * H * hd * 4 + H * T * T * 4 + B * H * T * 4 + B * T
        b_ms, b_by = bound(nbytes, 3 * 4 * B * H * T * T * hd, TF32_TC_FLOPS)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, kk, v))
        mask = gate[..., None] * bias[None] + torch.where(kpm, -1e30, 0.0)[:, None, None, :]
        rows.append(dict(
            name="fp32.fused_attention" + ("" if tag == "base" else ".large"), route="cuda",
            source=src + "flash_attention_f32.cu",
            replaces="unispeech_tpu/ops/pallas/flash_attention.py:878", launches=n,
            max_abs_err=err["attn" if tag == "base" else "attn.large"],
            ms=n * cuda_ms(lambda: flash_attention.fused_attention(*a)),
            device_ms=n * device_ms(lambda: flash_attention.fused_attention(*a)),
            plain_ms=n * cuda_ms(lambda: flash_attention.fused_attention_plain(*a), iters=5),
            bound_ms=n * b_ms, bound_by=b_by,
            **library_row(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), n)))
    for r in rows:
        phase("fp32", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                         for k, v in r.items() if k not in ("route", "source", "replaces")})
    return rows, e2e


def tf32_pin_phase(dev, wav, lengths, base_cfg):
    """tf32_pin: the fp32 model and the ECAPA head with the process's cuDNN
    flag at PyTorch's default (allow_tf32 True), held to the fp32 models'
    gate against the plain path with the flag off and to the speaker heads'
    gate against the CPU; the flag restored after. Returns the distances."""
    from unispeech_tpu_torch.configs import WavLMModelConfig
    from unispeech_tpu_torch.downstream import ecapa_tdnn as ecapa
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.ops import fp32_conv

    prev = torch.backends.cudnn.allow_tf32
    try:
        model = WavLM(WavLMModelConfig(encoder=base_cfg),
                      generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        torch.backends.cudnn.allow_tf32 = True
        out = model.extract_features(wav, lengths=lengths, collect_layer_outputs=True)
        torch.backends.cudnn.allow_tf32 = False
        with plain_ops():
            plain = model.extract_features(wav, lengths=lengths).x
        torch.backends.cudnn.allow_tf32 = True
        e_model = rel_l2(out.x, plain)
        # what the pin removes: the positional conv's input through F.conv1d
        # with the flag on (TF32) against the pinned fp32 conv
        pc = model.encoder.pos_conv
        x = plain.transpose(1, 2).contiguous()
        v = pc[0].weight_v
        w = pc[0].weight_g / v.norm(dim=(0, 1), keepdim=True).clamp_min(1e-12) * v
        with torch.no_grad():
            e_conv = rel_l2(F.conv1d(x, w, groups=pc.groups, padding=w.shape[-1] // 2),
                            fp32_conv.conv1d(x, w, groups=pc.groups, padding=w.shape[-1] // 2))
        phase("tf32_pin", model="base_plus", cudnn_allow_tf32=True,
              rel_l2_vs_plain_tf32_off=f"{e_model:.3g}", tol=F32_MODEL_REL_L2,
              pos_conv_unpinned_rel_l2=f"{e_conv:.3g}")
        if not e_model <= F32_MODEL_REL_L2:
            fail(f"tf32_pin: the fp32 Base+ forward with cudnn.allow_tf32 on is {e_model} "
                 "from its plain path")
        head = ecapa.EcapaTdnn(ecapa.EcapaConfig(), base_cfg.encoder_embed_dim,
                               generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        with torch.no_grad():
            got = head(out.layer_outputs, out.padding_mask)
        e_head = card_vs_cpu("tf32_pin", got,
                             head_on_cpu(head, out.layer_outputs.float(), out.padding_mask))
        del model, head, out, plain
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return e_model, e_head


# beside X-Large's 80: the narrowest head of width 80, width 96, and width
# 128's narrowest, XLS-R 2B's 120 and its widest
XL_F32_HEAD_DIMS = (72, 96, 104, 120, 128)


def fp32_wide_forward_parity(dev, q, kk, v, bias, gate, kpm, seed, frames):
    """The fp32 forward above head dim 64, in three forms: key padding with
    dropout 0.1 and no bias (X-Large's), the gated bias with key padding,
    and key padding with a (T, S) -1e4 band mask (which runs every key
    tile): out by f32_check (with the band mask on the rows with an open
    key inside the band; the rows whose open keys all sit behind it within
    F32_BEHIND_MASK_REL_L2), lse within 1e-4 plus 2 fp32 ulps of |lse| on
    the rows with a key (the card tests' rule: a row whose open keys all
    sit behind the -1e4 mask has an lse near -1e4, where one ulp is 1e-3),
    one launch per call; without dropout the row of length 0 is uniform
    over its S keys (the mean of v) in the kernel and the plain version.
    Returns the max abs error of out."""
    from unispeech_tpu_torch.ops.kernels import flash_attention

    B, T, H, hd = q.shape
    idx = torch.arange(T, device=dev)
    band = torch.where((idx[:, None] - idx[None, :]).abs() > 40, -1e4, 0.0)
    valid = frames > 0
    err = 0.0
    for form, kw in (("nobias_kpm_drop", dict(key_padding_mask=kpm, dropout_rate=0.1,
                                              dropout_seed=seed)),
                     ("bias_gate_kpm", dict(bias=bias, gate=gate, key_padding_mask=kpm)),
                     ("kpm_band_mask", dict(key_padding_mask=kpm, attn_mask=band))):
        name = f"fp32.fused_attention.hd{hd}.h{H}.{form}"
        before = flash_attention.launches
        out, lse = flash_attention.fused_attention(q, kk, v, **kw, return_lse=True)
        torch.cuda.synchronize()
        if flash_attention.launches != before + 1:
            fail(f"{name}: {flash_attention.launches - before} launches, not 1")
        pout, plse = flash_attention.fused_attention_plain(q, kk, v, **kw, return_lse=True)
        if "attn_mask" in kw:
            open_keys = ~kpm[:, None, :]
            in_band = (open_keys & (band == 0)[None]).any(-1)
            behind = open_keys.any(-1) & ~in_band
            err = max(err, f32_check(name + ".rows_open_in_band", out[in_band], pout[in_band]))
            rel = rel_l2(out[behind], pout[behind]) if behind.any() else 0.0
            phase("fp32", parity=f"{name}.rows_behind_mask", rows=int(behind.sum()),
                  rel_l2=f"{rel:.3g}", tol=f"rel_l2<={F32_BEHIND_MASK_REL_L2}")
            if not (torch.isfinite(out).all() and rel <= F32_BEHIND_MASK_REL_L2):
                fail(f"{name}: rows behind the mask at relative L2 {rel}, or non-finite")
        else:
            err = max(err, f32_check(name, out, pout))
        lse_err = float(((lse[valid] - plse[valid]).abs()
                         - 2 * 2.0 ** -23 * plse[valid].abs()).max())
        phase("fp32", parity=f"{name}.lse", excess_over_2_ulps=f"{lse_err:.3g}", tol=1e-4)
        if not lse_err <= 1e-4:
            fail(f"{name}: lse off by {lse_err} beyond 2 ulps")
        if "dropout_rate" not in kw:
            for b in (~valid).nonzero().flatten().tolist():
                mean = v[b].mean(0, keepdim=True).expand(T, H, hd)
                f32_check(f"{name}.len0_row{b}", out[b], mean)
                f32_check(f"{name}.len0_row{b}.plain", pout[b], mean)
        del out, lse, pout, plse
    return err


def fp32_wide_attention_parity(dev):
    """fp32_bwd above head dim 64: the fp32 attention forward
    (fp32_wide_forward_parity) and backward at X-Large's 16 heads of 80
    over its frames of the smoke batch (799/599/349/149) and a fifth row of
    length 0, and at hd 72, 96, 104, 120 and 128 on 3 rows of 333 frames (333/200/0)
    and 4 heads. The backward in the two forms that reach the wide kernels:
    key padding with dropout 0.1 and no bias (X-Large's), and the gated bias
    with key padding. dO is 0 on the row of length 0 (ROADMAP 3.5); both
    backwards take the plain forward's out and lse. dq, dk, dv by
    f32_check; dbias and dgate within 1e-5 of the sum of |terms|; two
    launches per call. Returns the max abs error of the forward's out and
    of dq, dk, dv."""
    from unispeech_tpu_torch.ops.kernels import flash_attention
    from unispeech_tpu_torch.ops.kernels.sum_terms import attn_terms

    enc = xlarge_config(0).encoder
    wav_lengths = [s * SAMPLE_RATE for s in UTTERANCE_SECONDS]
    xl_frames = [enc.num_frames(n) for n in wav_lengths] + [0]
    H_xl = enc.encoder_attention_heads
    hd_xl = enc.encoder_embed_dim // H_xl
    gen = torch.Generator().manual_seed(SEED + 36)
    err = 0.0
    for hd, H, frames in [(hd_xl, H_xl, xl_frames)] + [(d, 4, [333, 200, 0])
                                                        for d in XL_F32_HEAD_DIMS]:
        B, T = len(frames), max(frames)
        fr = torch.tensor(frames, device=dev)
        kpm = torch.arange(T, device=dev)[None, :] >= fr[:, None]
        q, kk, v = (torch.randn(B, T, H, hd, generator=gen).to(dev) for _ in range(3))
        bias = torch.randn(H, T, T, generator=gen).to(dev)
        gate = (torch.rand(B, H, T, generator=gen) * 2 + 1).to(dev)
        seed = torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64).to(dev)
        dout = (torch.randn(B, T, H, hd, generator=gen) * 1e-2).to(dev)
        dout = dout * (fr > 0)[:, None, None, None]
        err = max(err, fp32_wide_forward_parity(dev, q, kk, v, bias, gate, kpm, seed, fr))
        for form, kw in (("nobias_kpm_drop", dict(key_padding_mask=kpm, dropout_rate=0.1,
                                                  dropout_seed=seed)),
                         ("bias_gate_kpm", dict(bias=bias, gate=gate, key_padding_mask=kpm))):
            name = f"fp32.fused_attention_backward.hd{hd}.h{H}.{form}"
            pout, plse = flash_attention.fused_attention_plain(q, kk, v, **kw, return_lse=True)
            args = (q, kk, v, kw.get("bias"), kw.get("gate"), kpm, None,
                    kw.get("dropout_rate", 0.0), kw.get("dropout_seed"), pout, plse, dout)
            before = flash_attention.backward_launches
            got = flash_attention.fused_attention_backward(*args)
            torch.cuda.synchronize()
            if flash_attention.backward_launches != before + 2:
                fail(f"{name}: {flash_attention.backward_launches - before} launches, not 2")
            want = flash_attention.fused_attention_backward_plain(*args)
            for gname, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
                err = max(err, f32_check(f"{name}.{gname}", a, b))
            if "bias" in kw:
                terms = attn_terms(*args)
                sum_check(f"{name}.dbias", got[3], want[3], terms[0])
                sum_check(f"{name}.dgate", got[4], want[4], terms[1])
                del terms
            elif got[3] is not None or got[4] is not None:
                fail(f"{name}: dbias or dgate without a bias")
            del got, want, pout, plse
    return err


def fp32_training_phases(dev, clock):
    """fp32_bwd, fp32_train and fp32_large_train, then the times rows of the
    fp32 backward kernels and dropout forward per fp32 train step (measured
    here, so their inputs are freed before the later phases). Returns the
    rows and the two train phases' end-to-end numbers."""
    from unispeech_tpu_torch.configs import base_encoder_config, large_encoder_config

    f32 = torch.float32
    bw = backward_parity(dev, base_encoder_config(relative_position_embedding=True,
                                                  gru_rel_pos=True), dtype=f32)
    bw_large = backward_parity(dev, large_encoder_config(relative_position_embedding=True,
                                                         gru_rel_pos=True),
                               B=LARGE_B, ln_form=True, dtype=f32)
    fp32_wide_attention_parity(dev)
    clock.done("fp32_bwd")
    counts, large_counts = {}, {}
    e2e = {"fp32_train": train_phase(dev, kernel_counters(), counts, dtype=f32)}
    clock.done("fp32_train")
    e2e["fp32_large_train"] = train_phase(dev, kernel_counters(), large_counts, arch="large",
                                          dtype=f32)
    clock.done("fp32_large_train")
    rows = backward_times(bw, counts) + backward_times(bw_large, large_counts)
    clock.done("fp32_times")
    return rows, e2e


def fp32_e2e_lines(e2e, card, bf16):
    """The fp32 train steps' end-to-end lines, beside the bf16 steps'."""
    for name, e in e2e.items():
        phase(f"e2e_{name}", step_ms=f"{e['step_ms']:.3f}", host_enqueue_ms=f"{e['host_ms']:.3f}",
              audio_seconds_per_step=e["audio_s"],
              audio_sec_per_s=f"{e['audio_s'] / (e['step_ms'] / 1e3):.1f}",
              peak_memory_gb=f"{e['peak_gb']:.2f}", profiled_busy_ms=f"{e['busy_ms']:.3f}",
              profiled_wall_ms=f"{e['wall_ms']:.3f}", kernel_launches_per_step=e["launches"],
              card=card.replace(" ", "_"), bf16_step_ms=f"{bf16[name]['step_ms']:.3f}",
              bf16_peak_memory_gb=f"{bf16[name]['peak_gb']:.2f}")


def card_setup():
    """TF32 off for the plain versions, the card's line, the kernels built;
    returns the device and the nvidia-smi line."""
    from unispeech_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    lib = _build.build()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}", library=lib.name)
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    return dev, smi


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

    clock = PhaseClock()
    # 1 device, 2 build
    dev, smi = card_setup()
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

    # the fp32 forward kernels: Base+ and Large at the models' default dtype
    fp32_rows, fp32_e2e = fp32_phase(dev, wav, lengths, cfg, smi, _build.BUILD_DIR / "smoke_fp32")
    clock.done("fp32")
    tf32_pin_phase(dev, wav, lengths, cfg)
    clock.done("tf32_pin")

    # fp32 training: the fp32 backward kernels and dropout forward, then
    # WavLM-Base and WavLM-Large pretraining at the models' default dtype
    fp32_train_rows, fp32_train_e2e = fp32_training_phases(dev, clock)

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
    counters = kernel_counters()
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
        pipe = pipeline_phase(counters, tmp)
        clock.done("pipeline")
        # training across processes on the one card
        dist = dist_phase(dev, tmp, pipe)
        clock.done("dist")
        ctc_pipeline_phase(counters, tmp)
        clock.done("ctc_pipeline")
        # HuBERT X-Large (head dim 80): the attention kernels at the other
        # head dims, CTC fine-tuning at full width and depth, the CLIs
        xlarge_head_dims(dev)
        xl = xlarge_train_phase(dev, counters, wav, lengths, smi)
        xl_rows = xlarge_attention_rows(dev, lengths, xl)
        xl.update(xlarge_cli_phase(counters, tmp))
        clock.done("xlarge")
        # the same model built without a dtype (fp32): the fp32 attention
        # backward at hd 80 (row 2fX) on the main path
        xl32 = xlarge_train_phase(dev, counters, wav, lengths, smi, dtype=torch.float32)
        xl_rows += xlarge_attention_rows(dev, lengths, xl32, dtype=torch.float32)
        clock.done("fp32_xlarge")
        # fp32 CTC fine-tuning at XLS-R 2B's width (16 heads of 120): the
        # fp32 attention forward's width-128 form (rows 1fW, 1dfW) and the
        # backward's (2fW) on the main path. Its learning steps at 3.33e-5:
        # at 5e-5 the loss ended above its start (probe_xl_learning.py,
        # PERF.md section 4)
        xls = xlarge_train_phase(dev, counters, wav, lengths, smi, dtype=torch.float32,
                                 make_config=xlsr2b_config, tag="fp32_xlsr2b", head_dim=120,
                                 lr=3.33e-5)
        xl_rows += xlarge_attention_rows(dev, lengths, xls, dtype=torch.float32,
                                         make_config=xlsr2b_config, path="xlsr2b")
        clock.done("fp32_xlsr2b")
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

    # the checkpoint converters, then the speaker workload through its CLIs
    tmp = _build.BUILD_DIR / "smoke_speaker"
    try:
        speaker_files = convert_phase(tmp)
        clock.done("convert")
        spk = speaker_phase(dev, tmp, speaker_files)
        clock.done("speaker")
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
    rows += xl_rows
    rows += fp32_rows
    rows += fp32_train_rows
    rows.append(vpu_row)
    del bw, bw_large
    # each kernel family's launches in one frozen and one unfrozen CTC
    # fine-tuning step at WavLM-Large's width (its forms of the family)
    family = (("fp32.", None), ("l1_conv_with_stats.no_sums", 0), ("l1_conv_with_stats", None),
              ("l1_conv_backward", 1), ("conv_gelu_block_backward", 3),
              ("conv_gelu_block", 2), ("fused_attention_backward", 5),
              ("fused_attention", 4), ("vpu_micro", None))
    for r in rows:
        idx = next(i for prefix, i in family if r["name"].startswith(prefix))
        r["ctc_launches_frozen"] = 0 if idx is None else ctc_counts["frozen"][idx]
        r["ctc_launches_unfrozen"] = 0 if idx is None else ctc_counts["unfrozen"][idx]
        r["s2s_launches_frozen"] = 0 if idx is None else s2s_counts["frozen"][idx]
        r["s2s_launches_unfrozen"] = 0 if idx is None else s2s_counts["unfrozen"][idx]
        r["xlarge_launches_frozen"] = 0 if idx is None else xl["counts"]["frozen"][idx]
        r["xlarge_launches_unfrozen"] = 0 if idx is None else xl["counts"]["unfrozen"][idx]
        # the speaker path's forward launches: per verification batch, Large
        # and Base+ (the L1 with its sums), and per diarized recording (Large)
        large_i, base_i = SPEAKER_ROWS.get(r["name"], (None, None))
        r["speaker_launches_verification_batch"] = (
            0 if large_i is None else spk["ver"]["large"]["launches"][large_i])
        r["speaker_launches_verification_base_batch"] = (
            0 if base_i is None else spk["ver"]["base"]["launches"][base_i])
        r["speaker_launches_diarize_recording"] = (
            0 if large_i is None else spk["recs"][0][0][large_i])
        # the dist phase's launches: the FSDP CLI run (2 updates), and one
        # rank's step on the (2, 1) and (1, 2) meshes (Large, its forms)
        r["dist_launches_fsdp_cli"] = 0 if idx is None else dist["fsdp_cli"]["launches"][idx]
        r["dist_launches_dp_rank"] = (0 if idx is None
                                      else dist["dp"]["ranks"][0]["launches"][idx])
        r["dist_launches_tp_rank"] = (0 if idx is None
                                      else dist["tp"]["ranks"][0]["launches"][idx])
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
    fp32_e2e_lines(fp32_train_e2e, smi, bf16={"fp32_train": train,
                                              "fp32_large_train": large_train})
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
    phase("e2e_xlarge_train", params=xl["params"], frozen_step_ms=f"{xl['frozen_ms']:.3f}",
          unfrozen_step_ms=f"{xl['unfrozen_ms']:.3f}",
          host_enqueue_frozen_ms=f"{xl['host_frozen_ms']:.3f}",
          host_enqueue_unfrozen_ms=f"{xl['host_unfrozen_ms']:.3f}",
          audio_seconds_per_step=xl["audio_s"], padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s_frozen=f"{xl['audio_s'] / (xl['frozen_ms'] / 1e3):.1f}",
          audio_sec_per_s_unfrozen=f"{xl['audio_s'] / (xl['unfrozen_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{xl['peak_gb']:.2f}", finetune_cli_s=f"{xl['train_s']:.1f}",
          decode_cli_s=f"{xl['decode_s']:.1f}", card=smi.replace(" ", "_"))
    phase("e2e_fp32_xlarge", params=xl32["params"], frozen_step_ms=f"{xl32['frozen_ms']:.3f}",
          unfrozen_step_ms=f"{xl32['unfrozen_ms']:.3f}",
          host_enqueue_frozen_ms=f"{xl32['host_frozen_ms']:.3f}",
          host_enqueue_unfrozen_ms=f"{xl32['host_unfrozen_ms']:.3f}",
          audio_seconds_per_step=xl32["audio_s"], padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s_frozen=f"{xl32['audio_s'] / (xl32['frozen_ms'] / 1e3):.1f}",
          audio_sec_per_s_unfrozen=f"{xl32['audio_s'] / (xl32['unfrozen_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{xl32['peak_gb']:.2f}",
          profiled_busy_ms_unfrozen=f"{xl32['busy_ms']:.3f}",
          profiled_wall_ms_unfrozen=f"{xl32['wall_ms']:.3f}",
          kernel_launches_unfrozen=xl32["launches"], card=smi.replace(" ", "_"),
          bf16_unfrozen_step_ms=f"{xl['unfrozen_ms']:.3f}",
          bf16_peak_memory_gb=f"{xl['peak_gb']:.2f}")
    phase("e2e_fp32_xlsr2b", params=xls["params"], frozen_step_ms=f"{xls['frozen_ms']:.3f}",
          unfrozen_step_ms=f"{xls['unfrozen_ms']:.3f}",
          host_enqueue_frozen_ms=f"{xls['host_frozen_ms']:.3f}",
          host_enqueue_unfrozen_ms=f"{xls['host_unfrozen_ms']:.3f}",
          audio_seconds_per_step=xls["audio_s"], padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s_frozen=f"{xls['audio_s'] / (xls['frozen_ms'] / 1e3):.1f}",
          audio_sec_per_s_unfrozen=f"{xls['audio_s'] / (xls['unfrozen_ms'] / 1e3):.1f}",
          peak_memory_gb=f"{xls['peak_gb']:.2f}",
          profiled_busy_ms_unfrozen=f"{xls['busy_ms']:.3f}",
          profiled_wall_ms_unfrozen=f"{xls['wall_ms']:.3f}",
          kernel_launches_unfrozen=xls["launches"], card=smi.replace(" ", "_"))
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
    for arch, v in spk["ver"].items():
        phase(f"e2e_verification_{arch}", seconds_per_call=f"{v['seconds']:.2f}",
              trials_per_s=f"{v['trials_per_s']:.1f}",
              peak_memory_gb_above_start=f"{v['peak_gb']:.2f}",
              eer=v["eer"], launches_per_batch=v["launches"])
    phase("e2e_diarize", seconds_per_call=f"{spk['diarize_seconds']:.2f}",
          forward_seconds_per_recording=",".join(f"{s:.3f}" for _, s, _ in spk["recs"]),
          frames=",".join(str(t) for *_, t in spk["recs"]), der=spk["der"],
          peak_memory_gb_above_start=f"{spk['diarize_peak_gb']:.2f}")
    for name, e in (("e2e_w2v_train", w2v), ("e2e_sat_train", sat)):
        phase(name, params=e["params"], step_ms=f"{e['step_ms']:.3f}",
              host_enqueue_ms=f"{e['host_ms']:.3f}", audio_seconds_per_step=e["audio_s"],
              padded_seconds=B * NS / SAMPLE_RATE,
              audio_sec_per_s=f"{e['audio_s'] / (e['step_ms'] / 1e3):.1f}",
              peak_memory_gb=f"{e['peak_gb']:.2f}", profiled_busy_ms=f"{e['busy_ms']:.3f}",
              profiled_wall_ms=f"{e['wall_ms']:.3f}", kernel_launches_per_step=e["launches"])
    one = dist["one_process"]
    phase("e2e_dist", one_process_step_ms=f"{one['step_ms']:.1f}",
          one_process_peak_gb=f"{one['peak_gb']:.2f}",
          dp_step_ms=",".join(f"{x['step_ms']:.1f}" for x in dist["dp"]["ranks"]),
          dp_peak_gb=",".join(f"{x['peak_gb']:.2f}" for x in dist["dp"]["ranks"]),
          dp_grad_allreduce_ms=",".join(f"{x['grad_allreduce_ms']:.2f}"
                                        for x in dist["dp"]["ranks"]),
          tp_step_ms=",".join(f"{x['step_ms']:.1f}" for x in dist["tp"]["ranks"]),
          tp_peak_gb=",".join(f"{x['peak_gb']:.2f}" for x in dist["tp"]["ranks"]),
          tp_activation_allreduce_ms=",".join(f"{x['activation_allreduce_ms']:.2f}"
                                              for x in dist["tp"]["ranks"]),
          tp_allreduce_calls_per_step=dist["tp"]["ranks"][0]["allreduce_calls_per_step"],
          fsdp_cli_seconds=f"{dist['fsdp_cli']['seconds']:.1f}",
          mix_batch_device_ms=f"{dist['mix_card_ms']:.3f}", backend_dp_tp="gloo",
          backend_fsdp_cli="nccl")
    clock.done("times")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dist-worker"]:
        dist_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
                    sys.argv[6])
        sys.exit(0)
    sys.exit(main())
