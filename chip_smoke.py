#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (one NVIDIA H100): build, check, drive.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1 device   the card's name and power limit; TF32 off for the plain versions
  2 build    nvcc builds the port's kernels from unispeech_tpu_torch/csrc
  3 parity   each kernel against its plain PyTorch version, on the card, at
             the shapes the main path gives it, in bf16
  4 main     WavLM-Base+ (random weights from a seed, bf16) extract_features
             on a padded batch of 4 utterances (16/12/7/3 s), full depth and
             output_layer=6; launch counts per forward; the kernel path held
             against the same model with the three ops' plain versions
  5 cli      python -m unispeech_tpu_torch.tools dump-features --feature model
             on a manifest of wav files and a params .npz in the JAX layout
  6 times    each kernel, its plain version, its bound and one PyTorch
             library call; end-to-end audio-seconds per second

The line before the last is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import shutil
import subprocess
import sys
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent
SAMPLE_RATE = 16_000
UTTERANCE_SECONDS = (16, 12, 7, 3)
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12

# one bf16 ulp at a tensor's scale: two fp32 accumulation orders may round
# a value to neighbouring bf16 numbers (8 significant bits)
BF16_ULP = 2.0 ** -7


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


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


def smoke_batch(device):
    """4 utterances of 16/12/7/3 s of noise, zero-padded to 16 s."""
    gen = torch.Generator().manual_seed(SEED)
    ns = max(UTTERANCE_SECONDS) * SAMPLE_RATE
    lengths = torch.tensor([s * SAMPLE_RATE for s in UTTERANCE_SECONDS])
    wav = torch.randn(len(lengths), ns, generator=gen) * 0.1
    wav = wav * (torch.arange(ns)[None, :] < lengths[:, None])
    return wav.to(device), lengths.to(device)


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


def write_wav(path: pathlib.Path, samples: np.ndarray) -> None:
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from unispeech_tpu_torch.configs import WavLMModelConfig, base_encoder_config
    from unispeech_tpu_torch.convert.from_jax import jax_params_from_state_dict, save_params_npz
    from unispeech_tpu_torch.data.manifest import load_audio
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.ops.kernels import _build, conv_stack, flash_attention, l1_frontend
    from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    # 3 per-kernel parity at the main path's shapes
    cfg = base_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                              dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0)
    gen = torch.Generator().manual_seed(SEED + 1)
    wav, lengths = smoke_batch(dev)
    B, NS = wav.shape
    C = cfg.conv_layers[0][0]
    k0, s0 = cfg.conv_layers[0][1:]
    w1 = (torch.randn(k0, 1, C, generator=gen) * (2.0 / k0) ** 0.5).to(dev)
    y1, s1, s2, t1 = l1_frontend.l1_conv_with_stats(wav, w1, s0)
    py1, ps1, ps2, pt1 = l1_frontend.l1_conv_with_stats_plain(wav, w1, s0)
    torch.cuda.synchronize()
    if t1 != pt1:
        fail(f"l1 t1 {t1} != {pt1}")
    err_l1 = compare("l1_conv_with_stats.y1", y1, py1)
    # the sums: fp32 over t1 rows in two orders (thread rows + cross-tile
    # atomics vs the library reduction); bound 1e-4 of the sum of |terms|
    for nm, got, want, mag in (("s1", s1, ps1, py1.float().abs().sum(1)),
                               ("s2", s2, ps2, py1.float().square().sum(1))):
        e = float(((got - want).abs() / mag).max())
        phase("parity", kernel=f"l1_conv_with_stats.{nm}", max_rel_to_sum_abs=f"{e:.3g}",
              tol="1e-4")
        if not e <= 1e-4:
            fail(f"l1 {nm}: {e}")

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
    e_lse = float((lse - plse).abs().max())
    phase("parity", kernel="fused_attention.lse", max_abs_err=f"{e_lse:.3g}", tol="1e-3")
    if not e_lse <= 1e-3:  # fp32 sums in two orders: far below 1e-3 in a log
        fail(f"lse: {e_lse}")

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
    for name, res, got, want in (("full", main_out, main_launches, (1, 6, 12)),
                                 ("layer6", mid_out, mid_launches, (1, 6, 6))):
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

    # 5 the dump-features CLI on the card
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

    # 6 times at the main path's shapes (per forward: all launches of a kernel)
    wav_bf = wav.to(torch.bfloat16)[:, None, :]
    w1_lib = w1.permute(2, 1, 0).to(torch.bfloat16).contiguous()
    l1_bytes = B * NS * 4 + B * t1 * C * 2 + 2 * B * C * 4
    l1_flops = 2 * B * t1 * C * k0
    rows = [dict(
        name="l1_conv_with_stats", route="cuda", source="unispeech_tpu_torch/csrc/l1_frontend.cu",
        replaces="unispeech_tpu/ops/pallas/l1_frontend.py:164",
        launches=main_launches[0], max_abs_err=err_l1,
        ms=cuda_ms(lambda: l1_frontend.l1_conv_with_stats(wav, w1, s0)),
        plain_ms=cuda_ms(lambda: l1_frontend.l1_conv_with_stats_plain(wav, w1, s0), iters=5),
        bound_ms=1e3 * max(l1_bytes / HBM_BYTES_PER_S, l1_flops / FP32_FLOPS),
        bound_by="bytes" if l1_bytes / HBM_BYTES_PER_S >= l1_flops / FP32_FLOPS
        else "operations",
        library_ms=cuda_ms(lambda: F.conv1d(wav_bf, w1_lib, stride=s0)),
    )]
    conv_ms = conv_plain = conv_lib = conv_bound = 0.0
    conv_by = set()
    for args in conv_inputs:
        x, w = args[0], args[1]
        kw = w.shape[0]
        t_out = (x.shape[1] - kw) // 2 + 1
        conv_ms += cuda_ms(lambda: conv_stack.conv_gelu_block(*args))
        conv_plain += cuda_ms(lambda: conv_stack.conv_gelu_block_plain(*args), iters=5)
        xt = x.transpose(1, 2).contiguous()
        wt = w.permute(2, 1, 0).contiguous()
        conv_lib += cuda_ms(lambda: F.conv1d(xt, wt, stride=2))
        nbytes = (B * x.shape[1] * C + kw * C * C + B * t_out * C) * 2
        flops = 2 * B * t_out * C * kw * C
        conv_bound += 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS)
        conv_by.add("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_TC_FLOPS
                    else "operations")
        phase("times", kernel=f"conv_gelu_block.T{x.shape[1]}",
              bound_ms=f"{1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS):.4f}")
    rows.append(dict(
        name="conv_gelu_block", route="cuda", source="unispeech_tpu_torch/csrc/conv_stack.cu",
        replaces="unispeech_tpu/ops/pallas/conv_stack.py:156",
        launches=main_launches[1], max_abs_err=err_conv, ms=conv_ms, plain_ms=conv_plain,
        bound_ms=conv_bound, bound_by="operations" if "operations" in conv_by else "bytes",
        library_ms=conv_lib,
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
        plain_ms=n_attn * cuda_ms(lambda: flash_attention.fused_attention_plain(*attn_args),
                                  iters=5),
        bound_ms=n_attn * 1e3 * max(a_bytes / HBM_BYTES_PER_S, a_flops / BF16_TC_FLOPS),
        bound_by="bytes" if a_bytes / HBM_BYTES_PER_S >= a_flops / BF16_TC_FLOPS
        else "operations",
        library_ms=n_attn * cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)),
    ))
    for r in rows:
        phase("times", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.extract_features(wav, lengths=lengths)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device kernels only: the aten ops that launch them carry the same time
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    phase("profile", wall_ms=f"{wall_ms:.3f}", kernel_busy_ms=f"{busy_ms:.3f}",
          idle_share=f"{1 - busy_ms / wall_ms:.3f}",
          kernel_launches=sum(e.count for e in events))
    for e in events[:15]:
        phase("profile", kernel=e.key[:60].replace(" ", "_"), calls=e.count,
              device_ms=f"{device_us(e) / 1e3:.4f}")
    host_ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host_ops[:6]:
        phase("profile", host_op=e.key[:40], calls=e.count,
              self_cpu_ms=f"{e.self_cpu_time_total / 1e3:.3f}")
    phase("e2e", forward_ms=f"{fwd_ms:.3f}", host_enqueue_ms=f"{host_ms:.3f}",
          audio_seconds=audio_s,
          padded_seconds=B * NS / SAMPLE_RATE,
          audio_sec_per_s=f"{audio_s / (fwd_ms / 1e3):.1f}",
          kernel_share=f"{sum(r['ms'] for r in rows) / fwd_ms:.3f}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
