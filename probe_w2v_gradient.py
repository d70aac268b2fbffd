"""Trace the frontend LayerNorm bias's gradient in chip_smoke.py's w2v_train gate.

    python3 probe_w2v_gradient.py [--attempts N] [--gate-only] [--control N]

Run from the repository root, beside ``chip_smoke.py``, whose phase it
repeats; needs one CUDA device. The gate of ``w2v_train`` stacks, per
parameter tensor, the gradients of GRAD_DRAWS draws of a UniSpeech step at
WavLM-Large's width on three paths: the kernels (bf16), the plain versions
(bf16) and the plain versions on an fp32 copy. In some runs the kernel
path's error on the first frontend LayerNorm's bias
(``feature_extractor.conv_layers.0.2.1.bias``) is a few times the plain
path's. The runs differ only through the fp32 atomics of the three training
steps before the draws, so this script repeats the phase's steps and draws
(a fresh model each attempt) until the gate fails or ``--attempts`` run
out, and keeps the attempt whose bias tensor reads worst. On its weights
and its worst draw it then records, on each path, every conv block's input
gradient dx and output gradient dy and the L1 output y1, and prints per
stage:

- the path-level error: each block's dx column sums (over the batch and
  time; block 2's are the LayerNorm bias's gradient) and dy, and its
  output y on all rows and on the padded rows alone, kernel path and plain
  path against the fp32 path;
- the LayerNorm after each block alone: its backward (the block's dy)
  from the path's own output y and the fp32 path's incoming gradient, and
  from the fp32 path's y and the path's own incoming gradient, against the
  fp32 path's, which splits the dy error between the forward activations
  and the gradient coming in;
- the block's forward alone from the kernel path's input: kernel and plain
  version against fp64, on all rows and on the padded rows;
- each block's dx and dy on the padded rows alone, both paths against the
  fp32 path; and for blocks 3 and 4 the swap: dx formed from each path's
  own dy through the kernel and through the plain path's autograd, against
  the fp32 path's dx and against fp64 from the same dy, on the padded rows
  (which the LayerNorm before the block, at near-zero variance there,
  amplifies in its backward);
- the stage alone: block i's dx from the kernel path's own inputs (x, W,
  dy) through the kernel, the plain function, the plain path's autograd
  arithmetic and fp64, each against fp64: relative L2, the column sums'
  error relative to the sums' size, and the shrink
  sum((dx - dx64) sign(dx64)) / sum|dx64| (negative: values pulled toward
  zero, as a truncating accumulator does);
- the L1 forward's y1 (kernel, plain) against fp64 in the same terms;
- the fp32 reference the gate reads is the plain path run in fp32; beside
  it, the fp32 kernel path (the port's fp32 kernels, another summation
  order): the bias's gradient of both bf16 paths against both references,
  on the draw and stacked over all GRAD_DRAWS draws of the attempt;
- hybrids: the frontend kernels with the plain attention, and the plain
  frontend with the attention kernels, the attention's forward kernel
  with its plain backward, or its plain forward with the backward kernel:
  the gradient entering the frontend (block 7's dy) on the padded rows,
  and the bias's gradient, against the fp32 path.

With ``--control N`` it runs N attempts of a control instead: after the
phase's three kernel steps, each draw's gradients also go through two
reordered plain paths, the plain path whose conv blocks' forward values
come from one GEMM over the stride-2 windows of H (cuBLAS, in fp32 with
TF32 off, or in bf16 on the tensor cores with fp32 sums), the same
function and roundings as the plain version in another summation order,
with the plain version's backward. It prints the gate's worst ratio and
the bias's ratio for the kernel path and for each reordered path against
the plain path, and for the plain path against the fp32-reordered one,
and the share of conv block outputs (bf16) on the kernel path and each
reordered path that differ from the plain version's.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs

BIAS = "feature_extractor.conv_layers.0.2.1.bias"


@contextlib.contextmanager
def hybrid(frontend: str, attention: str):
    """The encoder's ops mixed: the frontend (L1 and conv blocks) through
    its kernels or plain versions; attention through the kernels, the plain
    version, the forward kernel with the plain merged backward, or the
    plain forward with the backward kernel."""
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

    saved = (encoder.l1_conv_with_stats, encoder.conv_gelu_block, encoder.fused_attention,
             flash_attention._forward, flash_attention.fused_attention_backward)
    if frontend == "plain":
        encoder.l1_conv_with_stats = l1_frontend.l1_conv_with_stats_plain
        encoder.conv_gelu_block = conv_stack.conv_gelu_block_plain
    if attention == "plain":
        encoder.fused_attention = flash_attention.fused_attention_plain
    elif attention == "fwd_kernel":
        flash_attention.fused_attention_backward = flash_attention.fused_attention_backward_plain
    elif attention == "bwd_kernel":
        def plain_forward(q, k, v, bias, gate, kpm, amask, rate, seed, want_lse):
            return flash_attention.fused_attention_plain(q, k, v, bias, gate, kpm, amask, rate,
                                                         seed, return_lse=True)
        flash_attention._forward = plain_forward
    try:
        yield
    finally:
        (encoder.l1_conv_with_stats, encoder.conv_gelu_block, encoder.fused_attention,
         flash_attention._forward, flash_attention.fused_attention_backward) = saved


@contextlib.contextmanager
def recording(store):
    """Record each conv block's inputs, dx and dy, and the L1's y1, on
    whatever ops the encoder uses (kernels or plain versions)."""
    from unispeech_tpu_torch.models import encoder

    conv, l1 = encoder.conv_gelu_block, encoder.l1_conv_with_stats

    def block(x, kernel, valid_len, gelu_in=False, gelu_out=True, affine=None):
        e = dict(x=x.detach(), w=kernel.detach(), valid=valid_len, gelu_in=gelu_in,
                 gelu_out=gelu_out, affine=affine)
        if x.requires_grad:
            x.register_hook(lambda g: e.__setitem__("dx", g.detach()))
        y, t = conv(x, kernel, valid_len, gelu_in, gelu_out, affine)
        e["y"] = y.detach()
        if y.requires_grad:
            y.register_hook(lambda g: e.__setitem__("dy", g.detach()))
        store.setdefault("blocks", []).append(e)
        return y, t

    def first(wav, kernel, stride, dtype=torch.bfloat16, with_stats=True):
        out = l1(wav, kernel, stride, dtype, with_stats)
        store["l1"] = dict(wav=wav.detach(), w=kernel.detach(), stride=stride, dtype=dtype,
                           y=out[0].detach())
        return out

    encoder.conv_gelu_block, encoder.l1_conv_with_stats = block, first
    try:
        yield
    finally:
        encoder.conv_gelu_block, encoder.l1_conv_with_stats = conv, l1


def dgelu64(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) + x * torch.exp(-0.5 * x * x) / math.sqrt(
        2.0 * math.pi)


def block_dx64(e, dy):
    """The block's dx in fp64 from its recorded bf16 inputs and dy (the
    layer_norm form: input GELU, no affine, no output GELU)."""
    x = e["x"].double()
    w = e["w"].double()  # (k, C_in, C_out)
    k = w.shape[0]
    t_out = dy.shape[1]
    g = dy.double()
    dxh = torch.zeros_like(x)
    for p in range(k):
        dxh[:, p:p + 2 * t_out:2] += g @ w[p].t()
    return dxh * dgelu64(x) if e["gelu_in"] else dxh


def block_y64(e):
    """The block's output in fp64 from its recorded inputs (layer_norm
    form)."""
    x = e["x"].double()
    h = 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))) if e["gelu_in"] else x
    w = e["w"].double()
    return F.conv1d(h.transpose(1, 2), w.permute(2, 1, 0), stride=2).transpose(1, 2)


def ln_backward(ln, y, d):
    """The gradient of a block's output y through the LayerNorm after it,
    from the LayerNorm output's gradient d."""
    yy = y.detach().clone().requires_grad_()
    out = ln(yy)
    (g,) = torch.autograd.grad(out, yy, d.to(out.dtype))
    return g


def frame_lengths(enc, lengths):
    """Valid frames of each utterance after each frontend layer."""
    n = lengths.long().cpu()
    out = []
    for _, k, s in enc.conv_layers:
        n = torch.clamp((n - k) // s + 1, min=0)
        out.append(n)
    return out


def padded_rows(t, n):
    """(B, T) bool: rows at or past each utterance's valid length."""
    return torch.arange(t)[None, :] >= n[:, None]


def block_dx_autograd(e, dy):
    """dx as the plain path computes it: autograd through the plain block."""
    from unispeech_tpu_torch.ops.kernels import conv_stack

    x = e["x"].clone().requires_grad_()
    y, _ = conv_stack.conv_gelu_block_plain(x, e["w"], e["valid"], e["gelu_in"], e["gelu_out"],
                                            e["affine"])
    (dx,) = torch.autograd.grad(y, x, dy)
    return dx


def versus(ref, got):
    """(relative L2, column-sum error over the sums' size, shrink) of got
    against the fp64 ref, both (B, T, C)."""
    ref, got = ref.double(), got.double()
    d = got - ref
    cs_ref, cs_d = ref.sum((0, 1)), d.sum((0, 1))
    return (float(d.norm() / ref.norm()), float(cs_d.norm() / cs_ref.norm()),
            float((d * torch.sign(ref)).sum() / ref.abs().sum()))


def fmt(v):
    return ",".join(f"{x:.3g}" for x in v)


def attempt_gate(cs, dev, wav, lengths):
    """One run of the phase's 3 steps and GRAD_DRAWS draws: (worst list,
    per draw stats, model, state step, model config, batch)."""
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step

    cfg, model, batch, loss_fn, gen = cs.contrastive_setup(dev, "w2v_train", wav, lengths)
    state = create_train_state(model, OptimConfig(lr=5e-4, warmup_steps=100, total_steps=1000),
                               device=dev)
    step = make_train_step(loss_fn)
    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    model32 = type(model)(cfg).to(dev)
    model32.load_state_dict(model.state_dict())
    seeds = [cs.SEED + 24 + d for d in range(cs.GRAD_DRAWS)]
    per_draw, _, _ = cs.contrastive_draws(model, model32, True, batch, state.step, seeds)
    del model32
    names = [n for n, _ in model.named_parameters()]
    worst, _ = cs.contrastive_worst(per_draw, names)
    return worst, per_draw, names.index(BIAS), model, state.step, cfg, batch


def reference_draws(cs, dev, model, cfg, batch, step_no, seeds, jb):
    """Per draw, the bias's gradient on the kernel path, the plain path, the
    plain path in fp32 and the kernel path in fp32; prints each bf16 path's
    error against each fp32 reference, per draw and stacked."""
    model32 = type(model)(cfg).to(dev)
    model32.load_state_dict(model.state_dict())
    err = {k: [] for k in ("kernel_vs_plain32", "plain_vs_plain32", "kernel_vs_kernel32",
                           "plain_vs_kernel32", "kernel32_vs_plain32")}
    for seed in seeds:
        picks, flips = [], []
        with cs.pinned_codewords(picks, flips):
            gk = cs.contrastive_grads(model, True, batch, step_no, seed)[jb].double()
        with cs.pinned_codewords(picks, flips), cs.plain_ops():
            gp = cs.contrastive_grads(model, True, batch, step_no, seed)[jb].double()
        with cs.pinned_codewords(picks, flips), cs.plain_ops():
            g32 = cs.contrastive_grads(model32, True, batch, step_no, seed)[jb].double()
        with cs.pinned_codewords(picks, flips):
            g32k = cs.contrastive_grads(model32, True, batch, step_no, seed)[jb].double()
        for name, a, b in (("kernel_vs_plain32", gk, g32), ("plain_vs_plain32", gp, g32),
                           ("kernel_vs_kernel32", gk, g32k), ("plain_vs_kernel32", gp, g32k),
                           ("kernel32_vs_plain32", g32k, g32)):
            err[name].append(float(((a - b) ** 2).sum()))
    del model32
    for name, v in err.items():
        print(f"[probe] reference {name} per_draw={fmt(math.sqrt(x) for x in v)} "
              f"stacked={math.sqrt(sum(v)):.4g}", flush=True)
    print(f"[probe] reference stacked_ratio_kernel_over_plain "
          f"vs_plain32={math.sqrt(sum(err['kernel_vs_plain32']) / sum(err['plain_vs_plain32'])):.3f} "
          f"vs_kernel32={math.sqrt(sum(err['kernel_vs_kernel32']) / sum(err['plain_vs_kernel32'])):.3f}",
          flush=True)


def analyse(cs, dev, model, cfg, batch, step_no, seed):
    """The stage-by-stage comparison on one draw."""
    from unispeech_tpu_torch.ops.kernels import conv_stack, l1_frontend

    model32 = type(model)(cfg).to(dev)
    model32.load_state_dict(model.state_dict())
    rec = {"kernel": {}, "plain": {}, "fp32": {}}
    picks, flips = [], []
    grads = {}
    with cs.pinned_codewords(picks, flips), recording(rec["kernel"]):
        grads["kernel"] = cs.contrastive_grads(model, True, batch, step_no, seed)
    with cs.pinned_codewords(picks, flips), cs.plain_ops(), recording(rec["plain"]):
        grads["plain"] = cs.contrastive_grads(model, True, batch, step_no, seed)
    with cs.pinned_codewords(picks, flips), cs.plain_ops(), recording(rec["fp32"]):
        grads["fp32"] = cs.contrastive_grads(model32, True, batch, step_no, seed)
    jb = [n for n, _ in model.named_parameters()].index(BIAS)
    gb = {k: v[jb].double() for k, v in grads.items()}
    e_k, e_p = float((gb["kernel"] - gb["fp32"]).norm()), float((gb["plain"] - gb["fp32"]).norm())
    print(f"[probe] draw_seed={seed} bias_grad_norm_fp32={float(gb['fp32'].norm()):.4g} "
          f"kernel_vs_fp32={e_k:.4g} plain_vs_fp32={e_p:.4g} ratio={e_k / max(e_p, 1e-30):.3f}",
          flush=True)
    # block 2's dx column sums are the bias's gradient (LayerNorm 0's output
    # feeds block 2 alone)
    cs2 = rec["kernel"]["blocks"][0]["dx"].double().sum((0, 1))
    print(f"[probe] bias_grad_vs_block2_dx_colsum rel={float((cs2 - gb['kernel']).norm() / gb['kernel'].norm()):.3g}",
          flush=True)

    # path level: each block's dx column sums and dy against the fp32 path
    for i, (bk, bp, b32) in enumerate(zip(*(rec[k]["blocks"] for k in ("kernel", "plain", "fp32"))),
                                      start=2):
        row = {}
        for name in ("dx", "dy"):
            ref = b32[name].double()
            for path, b in (("kernel", bk), ("plain", bp)):
                d = b[name].double() - ref
                row[f"{name}_{path}_rel_l2"] = float(d.norm() / ref.norm())
                row[f"{name}_colsum_{path}"] = float(d.sum((0, 1)).norm() / ref.sum((0, 1)).norm())
        print(f"[probe] path block=L{i} " + " ".join(f"{k}={v:.3g}" for k, v in row.items()),
              flush=True)

    # each block's output, and the LayerNorm after it alone
    flen = frame_lengths(cfg.encoder, batch["lengths"])
    blocks = {k: rec[k]["blocks"] for k in rec}
    for j in range(len(blocks["kernel"])):
        pad = padded_rows(blocks["fp32"][j]["y"].shape[1], flen[j + 1]).to(dev)
        y32 = blocks["fp32"][j]["y"].double()
        row = {}
        for path in ("kernel", "plain"):
            d = blocks[path][j]["y"].double() - y32
            row[f"y_{path}_rel_l2"] = float(d.norm() / y32.norm())
            row[f"y_{path}_padded_rel_l2"] = float(d[pad].norm() / max(float(y32[pad].norm()), 1e-30))
        rstd = torch.rsqrt(y32.var(-1, unbiased=False) + 1e-5)
        row["ln_rstd_padded_median"] = float(rstd[pad].median()) if pad.any() else 0.0
        row["ln_rstd_valid_median"] = float(rstd[~pad].median())
        if j + 1 < len(blocks["kernel"]):
            name = f"feature_extractor.conv_layers.{j + 1}.2.1"
            ln_k, ln_32 = model.get_submodule(name), model32.get_submodule(name)
            d32 = blocks["fp32"][j + 1]["dx"]
            ref = ln_backward(ln_32, blocks["fp32"][j]["y"], d32).double()
            for path in ("kernel", "plain"):
                yk, dk = blocks[path][j]["y"], blocks[path][j + 1]["dx"]
                for tag, got in (("both", ln_backward(ln_k, yk, dk)),
                                 ("own_y", ln_backward(ln_k, yk, d32)),
                                 ("own_dx", ln_backward(ln_32, blocks["fp32"][j]["y"], dk.float()))):
                    diff = got.double() - ref
                    row[f"ln_dy_{path}_{tag}_colsum"] = float(
                        diff.sum((0, 1)).norm() / ref.sum((0, 1)).norm())
                    row[f"ln_dy_{path}_{tag}_rel_l2"] = float(diff.norm() / ref.norm())
        print(f"[probe] forward block=L{j + 2} " + " ".join(
            f"{k}={v:.3g}" for k, v in row.items()), flush=True)
    del model32

    # hybrids: which op of the kernel path moves the gradient entering the
    # frontend on the padded rows
    dy32 = blocks["fp32"][-1]["dy"]
    pad7 = padded_rows(dy32.shape[1], flen[-1]).to(dev)
    for fe, at in (("kernel", "plain"), ("plain", "kernel"), ("plain", "fwd_kernel"),
                   ("plain", "bwd_kernel")):
        store = {}
        with cs.pinned_codewords(picks, flips), hybrid(fe, at), recording(store):
            gh = cs.contrastive_grads(model, True, batch, step_no, seed)
        d = store["blocks"][-1]["dy"].double() - dy32.double()
        e_pad = float(d[pad7].norm() / dy32.double()[pad7].norm())
        e_bias = float((gh[jb].double() - gb["fp32"]).norm())
        print(f"[probe] hybrid frontend={fe} attention={at} dy_L7_padded_rel_l2={e_pad:.3g} "
              f"bias_vs_fp32={e_bias:.4g} ratio_to_plain={e_bias / max(e_p, 1e-30):.3f}",
              flush=True)
        del store, gh

    # the padded rows alone, and the swap of dy and arithmetic at blocks 3, 4
    def prel(got, ref, rows):
        d = (got.double() - ref.double())[rows]
        return float(d.norm() / max(float(ref.double()[rows].norm()), 1e-30))

    for j in range(len(blocks["kernel"])):
        i = j + 2
        pad_in = padded_rows(blocks["fp32"][j]["dx"].shape[1], flen[i - 2]).to(dev)
        pad_out = padded_rows(blocks["fp32"][j]["dy"].shape[1], flen[i - 1]).to(dev)
        row = {f"{n}_{path}_padded_rel_l2": prel(blocks[path][j][n], blocks["fp32"][j][n], rows)
               for n, rows in (("dx", pad_in), ("dy", pad_out)) for path in ("kernel", "plain")}
        print(f"[probe] padded block=L{i} " + " ".join(f"{k}={v:.3g}" for k, v in row.items()),
              flush=True)
        if i not in (3, 4):
            continue
        ref32 = blocks["fp32"][j]["dx"]
        for src in ("kernel", "plain"):
            e = blocks[src][j]
            dy = e["dy"]
            dx64 = block_dx64(e, dy)
            got_k = conv_stack.conv_gelu_block_backward(e["x"], e["w"], e["valid"], e["gelu_in"],
                                                        e["gelu_out"], e["affine"], dy, None)[0]
            got_a = block_dx_autograd(e, dy)
            print(f"[probe] swap block=L{i} dy_from={src} "
                  f"kernel_vs_fp32_padded={prel(got_k, ref32, pad_in):.3g} "
                  f"autograd_vs_fp32_padded={prel(got_a, ref32, pad_in):.3g} "
                  f"fp64_vs_fp32_padded={prel(dx64, ref32, pad_in):.3g} "
                  f"kernel_vs_fp64_padded={prel(got_k, dx64, pad_in):.3g} "
                  f"autograd_vs_fp64_padded={prel(got_a, dx64, pad_in):.3g} "
                  f"kernel_vs_fp64_valid={prel(got_k, dx64, ~pad_in):.3g} "
                  f"autograd_vs_fp64_valid={prel(got_a, dx64, ~pad_in):.3g}", flush=True)
            del dx64, got_k, got_a

    # the stage alone, on the kernel path's own inputs, against fp64
    for i, e in enumerate(rec["kernel"]["blocks"], start=2):
        dy = e["dy"]
        ref = block_dx64(e, dy)
        got_k = conv_stack.conv_gelu_block_backward(e["x"], e["w"], e["valid"], e["gelu_in"],
                                                    e["gelu_out"], e["affine"], dy, None)[0]
        got_f = conv_stack.conv_gelu_block_backward_plain(e["x"], e["w"], e["valid"], e["gelu_in"],
                                                          e["gelu_out"], e["affine"], dy, None)[0]
        got_a = block_dx_autograd(e, dy)
        got_rec = e["dx"]
        res = {"kernel": versus(ref, got_k), "plain_fn": versus(ref, got_f),
               "plain_autograd": versus(ref, got_a), "recorded": versus(ref, got_rec)}
        print(f"[probe] stage block=L{i} dx rows={e['x'].shape[1]} " + " ".join(
            f"{k}=(rel_l2,colsum,shrink)({fmt(v)})" for k, v in res.items()), flush=True)
        del ref, got_k, got_f, got_a
        y64 = block_y64(e)
        pad = padded_rows(y64.shape[1], flen[i - 1]).to(dev)
        args = (e["x"], e["w"], e["valid"], e["gelu_in"], e["gelu_out"], e["affine"])
        with torch.no_grad():
            yk = conv_stack.conv_gelu_block(*args)[0].double()
            yp = conv_stack.conv_gelu_block_plain(*args)[0].double()
        fwd = {}
        for tag, got in (("kernel", yk), ("plain", yp)):
            d = got - y64
            fwd[tag] = (float(d.norm() / y64.norm()),
                        float(d[pad].norm() / max(float(y64[pad].norm()), 1e-30)),
                        float((d * torch.sign(y64)).sum() / y64.abs().sum()))
        print(f"[probe] stage block=L{i} y " + " ".join(
            f"{k}=(rel_l2,padded_rel_l2,shrink)({fmt(v)})" for k, v in fwd.items()), flush=True)
        del y64, yk, yp
    # the L1 forward, kernel and plain against fp64
    l1 = rec["kernel"]["l1"]
    k0 = l1["w"].shape[0]
    x64 = l1["wav"].double()[:, None, :]
    w64 = l1["w"].double().permute(2, 1, 0)
    y64 = F.conv1d(x64, w64, stride=l1["stride"]).transpose(1, 2)
    yk = l1_frontend.l1_conv_with_stats(l1["wav"], l1["w"], l1["stride"], l1["dtype"],
                                        with_stats=False)[0]
    yp = l1_frontend.l1_conv_with_stats_plain(l1["wav"], l1["w"], l1["stride"], l1["dtype"],
                                              with_stats=False)[0]
    print(f"[probe] stage l1.y1 k={k0} kernel=({fmt(versus(y64, yk))}) "
          f"plain=({fmt(versus(y64, yp))}) kernel_vs_plain_unequal={int((yk != yp).sum())}",
          flush=True)


# path -> [conv block outputs unlike the plain version's, outputs], per attempt
REORDERED_UNEQUAL = {}


@contextlib.contextmanager
def reordered_frontend(variant: str):
    """Plain ops everywhere, except that each conv block's forward values
    (the layer_norm form: no output GELU) are computed as one GEMM of the
    stride-2 windows of H (B t_out, k C) by the (k C, C) kernel: in fp32 by cuBLAS with TF32 off ("fp32") or in
    bf16 on the tensor cores with fp32 sums and no reduced-precision
    reduction ("bf16"), pre rounded to bf16 as the plain version rounds
    it. The gradient flows through the plain version."""
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

    def block(x, kernel, valid_len, gelu_in=False, gelu_out=True, affine=None):
        if gelu_out:
            # the plain block takes the output GELU of the fp32 sum, which a
            # bf16 GEMM does not return; the layer_norm form has none
            raise ValueError("the reordered block takes the layer_norm form (no output GELU)")
        y_p, t_out = conv_stack.conv_gelu_block_plain(x, kernel, valid_len, gelu_in, gelu_out,
                                                      affine)
        with torch.no_grad():
            _, h = conv_stack._block_input(x, valid_len, gelu_in, affine)
            h = h.contiguous()
            B, T, C = h.shape
            k = kernel.shape[0]
            win = h.as_strided((B, t_out, k * C), (T * C, 2 * C, 1)).reshape(-1, k * C)
            w = conv_stack.gemm_weight(kernel.to(x.dtype))  # (C_out, k C_in)
            if variant == "fp32":
                pre = (win.float() @ w.float().t()).to(x.dtype)
            else:
                pre = win @ w.t()
            y_r = pre.reshape(B, t_out, -1)
            tally = REORDERED_UNEQUAL.setdefault(variant, [0, 0])
            tally[0] += int((y_r != y_p).sum())
            tally[1] += y_p.numel()
        # forward value y_r exactly (a difference of two bf16 values and its
        # sum are exact in fp32), gradient through the plain version
        return (y_p.float() + (y_r.float() - y_p.float()).detach()).to(x.dtype), t_out

    saved = (encoder.l1_conv_with_stats, encoder.conv_gelu_block, encoder.fused_attention,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    encoder.l1_conv_with_stats = l1_frontend.l1_conv_with_stats_plain
    encoder.conv_gelu_block = block
    encoder.fused_attention = flash_attention.fused_attention_plain
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (encoder.l1_conv_with_stats, encoder.conv_gelu_block, encoder.fused_attention,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = saved


@contextlib.contextmanager
def kernel_frontend_tallied():
    """The kernel path, each conv block's forward values also compared with
    the plain version's on the same inputs (REORDERED_UNEQUAL["kernel"])."""
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.ops.kernels import conv_stack

    kernel_block = encoder.conv_gelu_block

    def block(x, kernel, valid_len, gelu_in=False, gelu_out=True, affine=None):
        y, t_out = kernel_block(x, kernel, valid_len, gelu_in, gelu_out, affine)
        with torch.no_grad():
            y_p, _ = conv_stack.conv_gelu_block_plain(x, kernel, valid_len, gelu_in, gelu_out,
                                                      affine)
            tally = REORDERED_UNEQUAL.setdefault("kernel", [0, 0])
            tally[0] += int((y != y_p).sum())
            tally[1] += y_p.numel()
        return y, t_out

    encoder.conv_gelu_block = block
    try:
        yield
    finally:
        encoder.conv_gelu_block = kernel_block


def control_attempts(cs, dev, wav, lengths, attempts: int):
    """The gate, per attempt, for the kernel path and the two reordered
    plain paths against the plain path, and for the plain path against the
    fp32-reordered one: the worst ratio over the tensors (the gate fails
    above 1) and the bias tensor's, the codeword choices pinned to the
    kernel path's for every path."""
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.state import create_train_state, make_train_step

    pairs = (("kernel", "plain"), ("fp32", "plain"), ("bf16", "plain"), ("plain", "fp32"))
    fails = {p: 0 for p in pairs}
    for a in range(attempts):
        t0 = time.perf_counter()
        cfg, model, batch, loss_fn, gen = cs.contrastive_setup(dev, "w2v_train", wav, lengths)
        state = create_train_state(model, OptimConfig(lr=5e-4, warmup_steps=100,
                                                      total_steps=1000), device=dev)
        step = make_train_step(loss_fn)
        for _ in range(3):
            step(state, batch, gen)
        torch.cuda.synchronize()
        model32 = type(model)(cfg).to(dev)
        model32.load_state_dict(model.state_dict())
        names = [n for n, _ in model.named_parameters()]
        jb = names.index(BIAS)
        per_draw = {p: [] for p in pairs}
        for d in range(cs.GRAD_DRAWS):
            seed = cs.SEED + 24 + d
            picks, flips = [], []
            g = {}
            with cs.pinned_codewords(picks, flips), kernel_frontend_tallied():
                g["kernel"] = cs.contrastive_grads(model, True, batch, state.step, seed)
            with cs.pinned_codewords(picks, flips), cs.plain_ops():
                g["plain"] = cs.contrastive_grads(model, True, batch, state.step, seed)
            for variant in ("fp32", "bf16"):
                with cs.pinned_codewords(picks, flips), reordered_frontend(variant):
                    g[variant] = cs.contrastive_grads(model, True, batch, state.step, seed)
            with cs.pinned_codewords(picks, flips), cs.plain_ops():
                g32 = cs.contrastive_grads(model32, True, batch, state.step, seed)
            for pa, pb in pairs:
                per_draw[(pa, pb)].append(torch.stack([
                    torch.stack([((x - y) ** 2).sum(), (y * y).sum(), ((x - c) ** 2).sum(),
                                 ((y - c) ** 2).sum()])
                    for x, y, c in zip(g[pa], g[pb], g32)], 1).double().cpu())
            del g, g32
        del model, model32, state
        parts = []
        for p in pairs:
            worst, _ = cs.contrastive_worst(per_draw[p], names)
            bias = next(w for w in worst if w[-1] == jb)
            fails[p] += worst[0][0] > 1.0
            parts.append(f"{p[0]}_vs_{p[1]}=(worst {worst[0][0]:.3f} {worst[0][2]}, "
                         f"bias {bias[0]:.3f}, bias_error_ratio {bias[4] / max(bias[5], 1e-30):.3f})")
        unequal = " ".join(f"{v}_unequal={n / max(m, 1):.3g}"
                           for v, (n, m) in REORDERED_UNEQUAL.items())
        REORDERED_UNEQUAL.clear()
        print(f"[control] attempt={a} seconds={time.perf_counter() - t0:.1f} {unequal} "
              + " ".join(parts), flush=True)
    print("[control] gate_failures " + " ".join(
        f"{pa}_vs_{pb}={n}/{attempts}" for (pa, pb), n in fails.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--attempts", type=int, default=6)
    ap.add_argument("--gate-only", action="store_true",
                    help="run every attempt (none stops early) and print the gate's "
                         "ratios, without the analysis of the worst attempt")
    ap.add_argument("--control", type=int, default=0,
                    help="run this many attempts of the reordered-plain control instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_w2v_gradient needs a CUDA device")
    from unispeech_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    wav, lengths = cs.smoke_batch(dev)
    if args.control:
        control_attempts(cs, dev, wav, lengths, args.control)
        return 0
    keep = None
    for a in range(args.attempts):
        t0 = time.perf_counter()
        worst, per_draw, j, model, step_no, cfg, batch = attempt_gate(cs, dev, wav, lengths)
        ratios = [math.sqrt(e[2, j] / max(e[3, j], 1e-60)) for e in per_draw]
        bias_row = next(w for w in worst if w[2] == BIAS)
        failed = worst[0][0] > 1.0
        print(f"[probe] attempt={a} seconds={time.perf_counter() - t0:.1f} gate_failed={failed} "
              f"worst={worst[0][2]} worst_of_tol={worst[0][0]:.3f} bias_of_tol={bias_row[0]:.3f} "
              f"bias_kernel_over_plain_fp32_error_per_draw={fmt(ratios)}", flush=True)
        if keep is None or bias_row[0] > keep[0]:
            keep = (bias_row[0], ratios, model.state_dict(), step_no, cfg, batch, a)
        del model
        if failed and not args.gate_only:
            break
    if args.gate_only:
        return 0
    score, ratios, sd, step_no, cfg, batch, a = keep
    d = max(range(len(ratios)), key=lambda i: ratios[i])
    print(f"[probe] analysing attempt={a} bias_of_tol={score:.3f} draw={d}", flush=True)
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel

    model = Wav2Vec2PretrainModel(cfg, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(sd)
    analyse(cs, dev, model, cfg, batch, step_no, cs.SEED + 24 + d)
    jb = [n for n, _ in model.named_parameters()].index(BIAS)
    reference_draws(cs, dev, model, cfg, batch, step_no,
                    [cs.SEED + 24 + i for i in range(cs.GRAD_DRAWS)], jb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
