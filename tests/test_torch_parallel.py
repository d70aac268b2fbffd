"""The port's training across processes (``parallel/``) on the CPU.

Two gloo processes are held against one process on the same global batch
stream: data parallelism over a (2, 1) mesh, FSDP over (2, 1), and tensor
parallelism over (1, 2) (gated rel-pos bias, the GLU feed-forward, iPQ
noise 0.1). Rows are of equal length, dropout and layerdrop are 0 and the
time masks are precomputed with equally many masked frames on each data
rank, so the ranks' batch-level feature penalties add up to the
one-process one (``train/state.py``); losses are held at rtol 2e-5 and
grad norms at 2e-4 over 3 steps, the JAX package's own two-process
tolerances (``tests/test_multiprocess.py``). The draw rules of
``models/encoder.py`` are checked under DP (layerdrop and sampled masks)
and TP (dropout); a (2, 1) FSDP run's checkpoint and export load into one
process and the export into the JAX model, and a resumed two-process run
repeats the uninterrupted one. The bootstrap and the tensor-parallel rules
are held against the JAX package's.

One launch of two workers and one single-process run compute every case
(a module fixture); each process runs one torch thread and has a timeout
of its own. JAX is imported only here, in the parent.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
GLOBAL_B, NS, STEPS = 4, 2000, 3
ENC = dict(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_layers=2,
           encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
           conv_pos=16, conv_pos_groups=4, dropout=0.0, attention_dropout=0.0,
           activation_dropout=0.0, encoder_layerdrop=0.0, relative_position_embedding=True,
           num_buckets=32, max_distance=64, gru_rel_pos=True)
# (name, mesh (n_data, n_model), fsdp, encoder overrides)
FORMS = [
    ("dp", (2, 1), False, {}),
    ("fsdp", (2, 1), True, {}),
    ("tp_glu", (1, 2), False, dict(activation_fn="glu", quant_noise_pq=0.1)),
    ("tp_ipq", (1, 2), False, dict(quant_noise_pq=0.1)),
]
TIMEOUT = 120


# -- the processes -------------------------------------------------------------

def _model(enc_over, seed=0):
    import torch

    from unispeech_tpu_torch.configs import EncoderConfig, HubertPretrainConfig, MaskConfig
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel

    cfg = HubertPretrainConfig(encoder=EncoderConfig(**{**ENC, **enc_over}),
                               time_mask=MaskConfig(mask_prob=0.5, mask_length=4),
                               num_classes=(10,), final_dim=8)
    return HubertPretrainModel(cfg, generator=torch.Generator().manual_seed(seed))


def _global_batch(step):
    """Row r of step i depends on (i, r) alone; every row masks 12 frames."""
    from unispeech_tpu_torch.configs import EncoderConfig

    T = EncoderConfig(**ENC).num_frames(NS)
    src = np.stack([np.random.default_rng(1000 * step + r).standard_normal(NS)
                    for r in range(GLOBAL_B)]).astype(np.float32)
    tgt = np.stack([np.random.default_rng(7000 * step + r).integers(0, 10, (T, 1))
                    for r in range(GLOBAL_B)]).astype(np.int64)
    mask = np.zeros((GLOBAL_B, T), bool)
    for r in range(GLOBAL_B):
        start = (7 * step + 5 * r) % (T - 12)
        mask[r, start:start + 12] = True
    return {"source": src, "targets": tgt, "boundary_mask": mask}


def _optim():
    from unispeech_tpu_torch.train.optim import OptimConfig

    return OptimConfig(lr=1e-3, schedule="fixed", weight_decay=0.0, clip_norm=1.0)


def _train(form, mesh=None):
    """Losses and grad norms of STEPS steps of ``form`` (on ``mesh``, else
    in one process on the global batch)."""
    import torch

    from unispeech_tpu_torch.parallel.sharding import local_rows, shard_batch
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
        shard_train_state,
    )
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    _, _, fsdp, over = form
    model = _model(over)
    state = create_train_state(model, _optim(), device="cpu")
    if mesh is not None:
        state = shard_train_state(state, mesh, tensor_parallel=mesh["model"].size() > 1,
                                  fsdp=fsdp)
    step = make_train_step(make_hubert_loss_fn(state.model, HubertCriterionConfig()))
    losses, norms = [], []
    for i in range(STEPS):
        b = _global_batch(i)
        if mesh is not None:
            b = local_rows(b)
        met = step(state, shard_batch(b, "cpu"), torch.Generator().manual_seed(42 + i))
        losses.append(float(met["loss_per_sample"]))
        norms.append(float(met["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}, state


class _Rows:
    """A resumable stream of this data rank's rows of the global batches."""

    def __init__(self):
        self.i = 0

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, d):
        self.i = int(d["i"])

    def __iter__(self):
        from unispeech_tpu_torch.parallel.sharding import local_rows

        while True:
            b = local_rows(_global_batch(self.i))
            self.i += 1
            yield b


def _run_loop(ckpt_dir, max_updates, export=None):
    """``run_training`` of the FSDP form over the current mesh; returns the
    final full state dict."""
    from unispeech_tpu_torch.parallel.sharding import full_state_dict
    from unispeech_tpu_torch.train.loop import LoopConfig, run_training
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    model = _model({})
    data = _Rows()
    cfg = LoopConfig(max_updates=max_updates, log_interval=1, save_interval_updates=2,
                     validate_interval_updates=0, checkpoint_dir=str(ckpt_dir), fsdp=True,
                     export_params=export, prefetch_depth=0)
    state = run_training(model, make_hubert_loss_fn(model, HubertCriterionConfig()),
                         _optim(), iter(data), cfg, device="cpu", data_state=data)
    return {k: v.cpu().numpy() for k, v in full_state_dict(state.model).items()}


def _draws(mesh, over):
    """Which layers ran, the time mask, and every parameter after one step
    of a model with ``over`` on ``mesh``."""
    import torch

    from unispeech_tpu_torch.parallel.sharding import local_rows, shard_batch
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
        shard_train_state,
    )
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    model = _model(over)
    state = shard_train_state(create_train_state(model, _optim(), device="cpu"), mesh,
                              tensor_parallel=mesh["model"].size() > 1)
    ran, masks = [], []
    layers = state.model.encoder.layers
    for i, layer in enumerate(layers):
        layer.register_forward_pre_hook(lambda m, a, i=i: ran.append(i))
    orig = state.model.forward

    def forward(*a, **k):
        res = orig(*a, **k)
        masks.append(res.mask_indices.cpu().numpy().astype(int).tolist())
        return res

    state.model.forward = forward
    b = local_rows({k: v for k, v in _global_batch(0).items() if k != "boundary_mask"})
    step = make_train_step(make_hubert_loss_fn(state.model, HubertCriterionConfig()))
    step(state, shard_batch(b, "cpu"), torch.Generator().manual_seed(3))
    params = {k: v.detach().numpy().tolist() for k, v in state.model.state_dict().items()}
    return {"ran": ran, "masks": masks, "params": params}


def worker(rank, world, port, outdir):
    import torch

    torch.set_num_threads(1)
    from unispeech_tpu_torch.parallel.bootstrap import maybe_initialize_distributed
    from unispeech_tpu_torch.parallel.sharding import make_mesh

    assert maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {}
    for form in FORMS:
        mesh = make_mesh(*form[1], device_type="cpu")
        res[form[0]] = _train(form, mesh)[0]
    mesh = make_mesh(2, 1, device_type="cpu")
    res["draws_dp"] = _draws(mesh, dict(encoder_layerdrop=0.5, encoder_layers=4))
    mesh = make_mesh(1, 2, device_type="cpu")
    res["draws_tp"] = _draws(mesh, dict(dropout=0.1, attention_dropout=0.1,
                                        activation_dropout=0.1))
    mesh = make_mesh(2, 1, device_type="cpu")
    out = pathlib.Path(outdir)
    full = _run_loop(out / "ckpt_full", 4)
    _run_loop(out / "ckpt_resume", 2)
    resumed = _run_loop(out / "ckpt_resume", 4, export=str(out / "export.npz"))
    res["resume_equal"] = all(np.array_equal(full[k], resumed[k]) for k in full)
    if rank == 0:
        np.savez(out / "full.npz", **full)
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def single(outdir):
    import torch

    torch.set_num_threads(1)
    res = {form[0]: _train(form)[0] for form in FORMS}
    pathlib.Path(outdir, "single.json").write_text(json.dumps(res))


# -- the tests ------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    port = _free_port()
    me = str(pathlib.Path(__file__).resolve())
    procs = [subprocess.Popen([sys.executable, me, "worker", str(r), "2", str(port), str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    procs.append(subprocess.Popen([sys.executable, me, "single", str(out)], cwd=REPO,
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True))
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    return out, ranks, json.loads((out / "single.json").read_text())


@pytest.mark.parametrize("form", [f[0] for f in FORMS])
def test_two_processes_match_one(runs, form):
    _, ranks, ref = runs
    # both ranks log the global values
    np.testing.assert_allclose(ranks[0][form]["losses"], ranks[1][form]["losses"], rtol=0)
    np.testing.assert_allclose(ranks[0][form]["grad_norms"], ranks[1][form]["grad_norms"],
                               rtol=0)
    np.testing.assert_allclose(ranks[0][form]["losses"], ref[form]["losses"], rtol=2e-5)
    np.testing.assert_allclose(ranks[0][form]["grad_norms"], ref[form]["grad_norms"],
                               rtol=2e-4)
    assert ref[form]["losses"][-1] != ref[form]["losses"][0]


def test_draw_rules_data_parallel(runs):
    """Layerdrop 0.5: both data ranks skip the same layers; sampled masks
    of their own rows differ."""
    _, ranks, _ = runs
    a, b = ranks[0]["draws_dp"], ranks[1]["draws_dp"]
    assert a["ran"] == b["ran"] and len(set(a["ran"])) < 4  # remat re-runs a layer
    assert a["masks"] != b["masks"] and np.asarray(a["masks"]).sum() > 0


def test_draw_rules_tensor_parallel(runs):
    """Dropout 0.1 under TP: after a step every parameter the model ranks
    hold whole is bitwise equal on both, and the split ones differ."""
    _, ranks, _ = runs
    a, b = ranks[0]["draws_tp"]["params"], ranks[1]["draws_tp"]["params"]
    from unispeech_tpu_torch.parallel.sharding import param_pspec

    whole = [k for k in a if "model" not in param_pspec(k, np.shape(a[k]), True, False)]
    assert any("layer_norm" in k for k in whole) and any("pos_conv" in k for k in whole)
    assert any("feature_extractor" in k for k in whole)
    for k in whole:
        assert a[k] == b[k], k
    assert a["encoder.layers.0.fc1.weight"] != b["encoder.layers.0.fc1.weight"]
    assert ranks[0]["draws_tp"]["masks"] == ranks[1]["draws_tp"]["masks"]


def test_checkpoint_resume_and_export(runs):
    """A (2, 1) FSDP checkpoint loads into one process (strict), equal to
    the gathered state; the resumed run repeats the uninterrupted one; the
    export loads into the JAX model, whose forward equals the port's."""
    import jax
    import jax.numpy as jnp
    import torch

    from unispeech_tpu.configs import EncoderConfig as JEncoderConfig
    from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
    from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
    from unispeech_tpu_torch.convert.from_jax import load_params_npz

    out, ranks, _ = runs
    assert ranks[0]["resume_equal"] and ranks[1]["resume_equal"]
    payload = torch.load(out / "ckpt_full" / "4" / "state.pt", weights_only=True)
    model = _model({})
    model.load_state_dict(payload["model"], strict=True)
    full = np.load(out / "full.npz")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), full[k], err_msg=k)
    assert payload["optimizer"]["state"][0]["exp_avg"].shape == \
        next(model.parameters()).shape

    jcfg = JHubertConfig(encoder=JEncoderConfig(**ENC), num_classes=(10,), final_dim=8)
    params = load_params_npz(str(out / "export.npz"))
    b = _global_batch(0)
    jout = JHubert(jcfg).apply({"params": jax.tree.map(jnp.asarray, params)},
                               jnp.asarray(b["source"]), features_only=True, mask=False,
                               deterministic=True)
    with torch.no_grad():
        tout = model(torch.as_tensor(b["source"]), features_only=True, mask=False)
    np.testing.assert_allclose(np.asarray(jout.x), tout.x.numpy(), rtol=1e-4, atol=1e-4)


def test_bootstrap_env_rules():
    """``multihost_env_detected`` agrees with the JAX rule on SLURM
    environments, and reads torchrun's WORLD_SIZE; the launch resolves
    arguments, then torchrun's variables, then SLURM's."""
    from unispeech_tpu.parallel.bootstrap import multihost_env_detected as jax_rule
    from unispeech_tpu_torch.parallel.bootstrap import multihost_env_detected, resolve_launch

    for env in ({}, {"SLURM_JOB_NUM_NODES": "1"}, {"SLURM_JOB_NUM_NODES": "2"},
                {"SLURM_JOB_NUM_NODES": "16", "SLURM_PROCID": "3"},
                {"SLURM_NTASKS": "8", "SLURM_PROCID": "1"}):
        assert multihost_env_detected(env) == jax_rule(env), env
    assert multihost_env_detected({"WORLD_SIZE": "4"})
    assert not multihost_env_detected({"WORLD_SIZE": "1"})
    assert resolve_launch(environ={}) is None
    tr = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5",
          "LOCAL_RANK": "1"}
    assert resolve_launch(environ=tr) == ("10.0.0.1:29500", 8, 5, 1)
    assert resolve_launch("h:1", 2, 0, environ=tr) == ("h:1", 2, 0, 1)
    slurm = {"SLURM_JOB_NUM_NODES": "2", "SLURM_NTASKS": "4", "SLURM_PROCID": "3",
             "SLURM_LOCALID": "1", "MASTER_ADDR": "n0", "MASTER_PORT": "1"}
    assert resolve_launch(environ=slurm) == ("n0:1", 4, 3, 1)
    with pytest.raises(ValueError):
        resolve_launch(environ={"SLURM_JOB_NUM_NODES": "2"})


def _jax_tp_dim(params_path, shape):
    from unispeech_tpu.parallel.sharding import param_pspec as jax_pspec

    spec = tuple(jax_pspec(params_path, shape, tensor_parallel=True, fsdp=False, n_data=1))
    spec = spec + (None,) * (len(shape) - len(spec))
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("glu", [False, True])
def test_tp_rules_match_jax(glu):
    """For every parameter of the WavLM-Large HubertPretrainModel tree (two
    layers, narrow widths: the names and layouts are Large's), and of a GLU
    encoder, the port's rule splits the same logical dim as the JAX rule on
    the JAX tree, transposed for the (out, in) layout. Each tensor is filled
    with its own run of ids, carried to the JAX tree by the converter, so
    the ids of each rank's slice must be those of the JAX rule's; a GLU fc1
    splits each of its halves."""
    import torch

    from unispeech_tpu_torch.configs import HubertPretrainConfig, large_encoder_config
    from unispeech_tpu_torch.convert.from_jax import jax_params_from_hubert_state_dict
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.parallel.sharding import param_pspec
    from unispeech_tpu_torch.parallel.tensor_parallel import tp_slice

    over = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                conv_layers=((32, 10, 5), (32, 3, 2)), conv_pos=8, conv_pos_groups=4,
                activation_fn="glu" if glu else "gelu", relative_position_embedding=True,
                gru_rel_pos=True)
    cfg = HubertPretrainConfig(encoder=large_encoder_config(**over), num_classes=(12,),
                               final_dim=16)
    model = HubertPretrainModel(cfg)
    sd, start = {}, 1
    for k, v in model.state_dict().items():
        sd[k] = torch.arange(start, start + v.numel(), dtype=torch.float32).reshape(v.shape)
        start += v.numel()
    leaves = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            leaves[prefix] = np.asarray(node)

    walk("", jax_params_from_hubert_state_dict(sd, cfg))
    where = {int(v): path for path, arr in leaves.items() for v in arr.ravel()}
    n_split = 0
    for name, p in model.named_parameters():
        t = sd[name]
        jpath = where[int(t.min())]
        arr = leaves[jpath]
        jdim = _jax_tp_dim(jpath, arr.shape)
        if arr.size != t.numel():  # the layers stacked on a leading axis
            (layer,) = {i for i in range(arr.shape[0]) if int(t.min()) in arr[i]}
            arr = arr[layer]
            jdim = None if jdim is None else jdim - 1
        assert sorted(arr.ravel().tolist()) == t.ravel().tolist(), name
        mine = param_pspec(name, tuple(p.shape), tensor_parallel=True, fsdp=False)
        assert ("model" in mine) == (jdim is not None), (name, jpath)
        if jdim is None:
            continue
        n_split += 1
        halves = np.array_split(arr, 2, axis=jdim) if name.endswith(".linear.weight") \
            or name.endswith(".linear.bias") else [arr]
        for r in range(2):
            ref = np.concatenate([np.array_split(h, 2, axis=jdim)[r].ravel() for h in halves])
            ours = tp_slice(t, mine.index("model"), len(halves) == 2, r, 2)
            assert sorted(ref.tolist()) == sorted(ours.ravel().tolist()), (name, jpath, r)
    assert n_split == 10 * 2  # q, k, v (weight, bias), out_proj, fc1 (2), fc2 per layer


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        single(sys.argv[2])
