"""The port's training loop, checkpoints, metrics, watchdog and
``pretrain-hubert`` CLI (CPU).

The checkpoint cases are the JAX package's (``tests/test_train_loop.py``)
on the ``torch.save`` manager. A resumed ``run_training`` must repeat the
uninterrupted run exactly: every generator is seeded from (seed, update)
and a checkpoint holds the data state of the last batch consumed, so the
parameters and AdamW moments are compared bit for bit. The CLI's params
export is loaded into the JAX ``HubertPretrainModel`` and the port's
model; both forwards in fp32, logits within rtol/atol 1e-5 (one forward,
sums in other orders).
"""

import dataclasses
import glob
import json
import os
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
from unispeech_tpu.configs import large_encoder_config as jax_large_encoder_config
from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
from unispeech_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from unispeech_tpu.train.loop import group_microbatches as jax_group_microbatches
from unispeech_tpu_torch.configs import (
    GumbelVQConfig,
    HubertPretrainConfig,
    MaskConfig,
    Wav2Vec2PretrainConfig,
    base_encoder_config,
    large_encoder_config,
)
from unispeech_tpu_torch.convert.from_jax import hubert_state_dict_from_jax
from unispeech_tpu_torch.data.dataset import DataConfig, FinetuneIterator, PretrainIterator
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.data.labels import LabelFile
from unispeech_tpu_torch.data.manifest import Manifest
from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
from unispeech_tpu_torch.train.__main__ import main as train_cli
from unispeech_tpu_torch.train.checkpoint import CheckpointManager
from unispeech_tpu_torch.train.loop import LoopConfig, group_microbatches, run_training
from unispeech_tpu_torch.train.losses import HubertCriterionConfig
from unispeech_tpu_torch.train.optim import OptimConfig
from unispeech_tpu_torch.train.state import create_train_state
from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn, make_wav2vec2_loss_fn
from unispeech_tpu_torch.utils.debug import HangWatchdog, nonfinite_paths
from unispeech_tpu_torch.utils.metrics import MetricsAggregator, ProgressLogger

TINY = dict(
    conv_layers=[[32, 10, 5], [32, 3, 2], [32, 3, 2], [32, 2, 2]],
    encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
    encoder_attention_heads=2, conv_pos=8, conv_pos_groups=2, num_buckets=16,
    max_distance=32,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under a
    parallel test run (several worker processes on few cores) OpenMP's
    spinning threads slow them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_enc(fn=base_encoder_config, **over):
    kw = dict(TINY, conv_layers=tuple(map(tuple, TINY["conv_layers"])))
    return fn(relative_position_embedding=True, gru_rel_pos=True, **kw, **over)


def _state(seed=0):
    model = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(model.weight, float(seed))
    return create_train_state(model, OptimConfig(schedule="fixed"), device="cpu")


def _corpus(tmp_path, n=6, seed=0):
    """Wav files of 0.5-1.5 s, their manifest and 100 Hz labels."""
    rng = np.random.default_rng(seed)
    rows, labs = [], []
    for i in range(n):
        m = int(rng.integers(8000, 24000))
        pcm = np.clip(rng.standard_normal(m) * 0.1 * 32767, -32768, 32767).astype(np.int16)
        with wave.open(str(tmp_path / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        rows.append(f"u{i}.wav\t{m}")
        labs.append(" ".join(str(x) for x in rng.integers(0, 10, 1 + (m - 400) // 160)))
    (tmp_path / "train.tsv").write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")
    (tmp_path / "train.km").write_text("\n".join(labs) + "\n")
    return tmp_path


# ----------------------------------------------------------- checkpoints
def test_checkpoint_keep_last_and_restore(tmp_path):
    m = CheckpointManager(str(tmp_path / "c"), keep_last=2, best_metric="loss_avg")
    assert m.restore(_state()) == (None, 0) and m.latest_step() is None
    for step in (1, 2, 3):
        st = _state(step)
        st.step = step
        assert m.save(step, st, data_state={"epoch": 1, "batch_offset": step})
    assert not m.save(3, _state())  # an existing step is not saved again
    assert m.all_steps() == [2, 3] and m.latest_step() == 3 and m.best_step() is None
    st = _state()
    data, step = m.restore(st)
    assert (data, step, st.step) == ({"epoch": 1, "batch_offset": 3}, 3, 3)
    assert float(st.model.weight.detach()[0, 0]) == 3.0
    data, step = m.restore(st, step=2)
    assert step == 2 and float(st.model.weight.detach()[0, 0]) == 2.0
    # a new manager over the directory sees the same checkpoints
    assert CheckpointManager(str(tmp_path / "c"), keep_last=2).all_steps() == [2, 3]


def test_best_checkpoint_misaligned_intervals(tmp_path):
    """An unvalidated checkpoint never becomes best (it scores the worst
    value, not 0); the latest survive pruning beside an old best."""
    m = CheckpointManager(str(tmp_path / "c"), keep_last=3, best_metric="loss_avg",
                          maximize_best=False)
    st = _state()
    m.save(1, st, metrics=None)
    m.save(2, st, metrics={"loss_avg": 5.0})
    m.save(3, st, metrics={"loss_avg": 4.0})
    m.save(4, st, metrics=None)
    assert m.best_step() == 3 and m.latest_step() == 4
    m.save(5, st, metrics={"loss_avg": 6.0})
    m.save(6, st, metrics={"loss_avg": 7.0})
    steps = set(m.all_steps())
    assert m.latest_step() == 6 and 6 in steps
    assert m.best_step() == 3 and 3 in steps
    assert steps == {3, 4, 5, 6}
    reopened = CheckpointManager(str(tmp_path / "c"), keep_last=3, best_metric="loss_avg")
    assert reopened.best_step() == 3
    maxm = CheckpointManager(str(tmp_path / "d"), keep_last=1, best_metric="acc",
                             maximize_best=True)
    for step, acc in ((1, 0.5), (2, 0.9), (3, 0.7)):
        maxm.save(step, st, metrics={"acc": acc})
    assert maxm.all_steps() == [2, 3] and maxm.best_step() == 2


class FakeData:
    """Deterministic synthetic batches with a resumable cursor."""

    def __init__(self, n_frames, n_samples=3200, B=2):
        self.n_frames, self.n, self.B = n_frames, n_samples, B
        self.cursor = 0

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, d):
        self.cursor = int(d["cursor"])

    def batch(self, i):
        rng = np.random.default_rng(i)
        return {
            "source": rng.standard_normal((self.B, self.n)).astype(np.float32),
            "targets": rng.integers(0, 10, (self.B, self.n_frames, 1)).astype(np.int32),
            "lengths": np.full((self.B,), self.n, np.int32),
        }

    def __iter__(self):
        while True:
            b = self.batch(self.cursor)
            self.cursor += 1
            yield b


def _tiny_hubert(seed=0, **enc_over):
    enc = _tiny_enc(**dict(dict(dropout=0.1, attention_dropout=0.1, encoder_layerdrop=0.2),
                           **enc_over))
    cfg = HubertPretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.5, mask_length=4),
                               num_classes=(10,), final_dim=8)
    model = HubertPretrainModel(cfg, generator=torch.Generator().manual_seed(seed))
    return model, make_hubert_loss_fn(model, HubertCriterionConfig())


def test_loop_carries_validation_metrics_to_misaligned_saves(tmp_path):
    """A save at step 3 (validation every 2) carries the step-2 validation
    metrics; the save at step 2 carries none, and no save repeats one."""
    model, loss_fn = _tiny_hubert()
    data = FakeData(model.pcfg.encoder.num_frames(3200))
    cfg = LoopConfig(max_updates=3, log_interval=10, save_interval_updates=3,
                     validate_interval_updates=2, max_valid_steps=1,
                     checkpoint_dir=str(tmp_path / "ckpt"), seed=0)
    run_training(model, loss_fn, OptimConfig(lr=1e-3, schedule="fixed"), iter(data), cfg,
                 device="cpu", valid_batches_fn=lambda: iter([data.batch(99)]),
                 eval_loss_fn=loss_fn, data_state=data)
    metas = {}
    for p in glob.glob(str(tmp_path / "ckpt" / "*" / "meta.json")):
        meta = json.load(open(p))
        metas[meta["step"]] = meta["metrics"]
    assert sorted(metas) == [3] and "loss_avg" in metas[3], metas


@pytest.mark.parametrize("k", [2, 3])
def test_group_microbatches_matches_jax(k, caplog):
    rng = np.random.default_rng(k)
    stream = [{"x": rng.standard_normal((2, n)).astype(np.float32),
               "y": np.full((2,), n, np.int32)} for n in rng.choice([4, 6], 11)]
    caplog.set_level("WARNING")
    got = list(group_microbatches(iter(stream), k))
    want = list(jax_group_microbatches(iter(stream), k))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    assert sum("dropped" in r.getMessage() for r in caplog.records) == 2


def test_hang_watchdog_fires_and_disarms():
    w = HangWatchdog(timeout_s=0.1, kill=False)
    w.arm()
    time.sleep(0.4)
    assert w.fired == 1
    w.arm()
    w.disarm()
    time.sleep(0.3)
    assert w.fired == 1


def test_progress_logger_sinks_fail_soft_and_metrics(capsys):
    lg = ProgressLogger("train", wandb_project="nope", azureml=True)
    lg.log(1, {"loss": 1.0, "bad": float("nan")})
    lg.close()
    err = capsys.readouterr().err
    assert '"tag": "train"' in err and '"loss": 1.0' in err and "sink_disabled" in err
    agg = MetricsAggregator()
    agg.update({"loss": torch.tensor(6.0), "sample_size": 3, "n": np.float32(1)})
    agg.update({"loss": torch.tensor(2.0), "sample_size": 1, "n": np.float32(1)})
    snap = agg.snapshot()
    assert snap["loss_avg"] == 2.0 and snap["steps"] == 2 and snap["n"] == 2.0


def test_nonfinite_paths_names_bad_tensors():
    sd = {"a": torch.zeros(3), "b": torch.tensor([1.0, float("nan")]),
          "c": torch.tensor([float("inf")]), "i": torch.tensor([1, 2])}
    assert nonfinite_paths(sd) == [("b", "nan"), ("c", "inf")]


def _run(tmp_path, ckpt, max_updates, corpus, accum_steps=1):
    model, loss_fn = _tiny_hubert()
    enc = model.pcfg.encoder
    data = PretrainIterator(Manifest.load(str(corpus / "train.tsv")),
                            DataConfig(max_sample_size=20000, min_sample_size=8000,
                                       max_tokens=48000, num_buckets=3, label_rate=100.0,
                                       required_batch_size_multiple=2),
                            [LabelFile(str(corpus / "train.km"), 100.0)],
                            frame_hop=enc.frame_hop, frames_fn=enc.num_frames, seed=3)
    cfg = LoopConfig(max_updates=max_updates, log_interval=1, save_interval_updates=2,
                     checkpoint_dir=str(tmp_path / ckpt), seed=5, accum_steps=accum_steps)
    state = run_training(model, loss_fn, OptimConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                         iter(data), cfg, device="cpu", data_state=data)
    return state, data


def test_resumed_run_equals_uninterrupted(tmp_path):
    """4 updates in one run against 2, a resume from the checkpoint, 2 more:
    the same parameters and AdamW state bit for bit (dropout, layerdrop and
    the masks on; the batches from PretrainIterator through the prefetch
    thread, which reads ahead of the loop)."""
    corpus = _corpus(tmp_path)
    full, full_data = _run(tmp_path, "a", 4, corpus)
    _run(tmp_path, "b", 2, corpus)
    resumed, resumed_data = _run(tmp_path, "b", 4, corpus)
    assert full.step == resumed.step == 4 and full.optimizer.count == 4
    assert sorted(os.listdir(tmp_path / "b")) == ["2", "4"]
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = full.optimizer.adamw.state_dict(), resumed.optimizer.adamw.state_dict()
    for i in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])
    payload = torch.load(tmp_path / "b" / "4" / "state.pt", weights_only=True)
    assert payload["data"]["iterator"]["batch_offset"] > 0 and payload["step"] == 4


def test_resumed_run_equals_uninterrupted_grouped(tmp_path):
    """The same with accum_steps=2 over two bucket shapes (A B A A B ...):
    at the checkpoint after update 1, draw 1 (B) waits in its shape's buffer
    while draw 2 (A) was trained on, so the checkpoint names the data state
    from before draw 1 and skips draw 2. 4 updates in one run against 1, a
    resume, 3 more: the same parameters and AdamW state bit for bit."""
    corpus = _corpus(tmp_path, seed=1)
    full, _ = _run(tmp_path, "a", 4, corpus, accum_steps=2)
    _run(tmp_path, "b", 1, corpus, accum_steps=2)
    payload = torch.load(tmp_path / "b" / "1" / "state.pt", weights_only=True)
    assert payload["data"]["iterator"]["batch_offset"] == 1 and payload["data"]["skip"] == [1]
    resumed, _ = _run(tmp_path, "b", 4, corpus, accum_steps=2)
    assert full.step == resumed.step == 4 and full.optimizer.count == 4
    assert sorted(os.listdir(tmp_path / "b")) == ["1", "2", "4"]
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = full.optimizer.adamw.state_dict(), resumed.optimizer.adamw.state_dict()
    for i in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])


def _run_unispeech(tmp_path, ckpt, max_updates, corpus):
    """UniSpeech multitask pretraining (mtlalpha 0.5) from a FinetuneIterator."""
    enc = _tiny_enc(dropout=0.1, attention_dropout=0.1, encoder_layerdrop=0.2,
                    dropout_features=0.1)
    cfg = Wav2Vec2PretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.5, mask_length=4),
                                 final_dim=8, num_negatives=4, cross_sample_negatives=2,
                                 quantizer=GumbelVQConfig(num_vars=6, groups=2, vq_dim=8),
                                 transpose=True, ctc_vocab_size=len(Dictionary.letters()))
    model = Wav2Vec2PretrainModel(cfg, generator=torch.Generator().manual_seed(0))
    man = Manifest.load(str(corpus / "train.tsv"))
    texts = ["A B | C |"] * len(man)
    data = FinetuneIterator(man, DataConfig(max_sample_size=20000, min_sample_size=8000,
                                            max_tokens=48000, num_buckets=3,
                                            required_batch_size_multiple=2),
                            texts, Dictionary.letters(), seed=3)
    loop = LoopConfig(max_updates=max_updates, log_interval=1, save_interval_updates=2,
                      checkpoint_dir=str(tmp_path / ckpt), seed=5)
    return run_training(model, make_wav2vec2_loss_fn(model, mtlalpha=0.5),
                        OptimConfig(lr=1e-3, warmup_steps=2, total_steps=8), iter(data), loop,
                        device="cpu", data_state=data)


def test_resumed_run_equals_uninterrupted_wav2vec2(tmp_path):
    """The same for UniSpeech pretraining, whose update generator feeds the
    mask, dropout (with dropout_features and final_dropout), the Gumbel
    noise, the negatives and the CTC head's replace mask: 4 updates in one
    run against 2, a resume, 2 more, bit for bit."""
    corpus = _corpus(tmp_path)
    full = _run_unispeech(tmp_path, "a", 4, corpus)
    _run_unispeech(tmp_path, "b", 2, corpus)
    resumed = _run_unispeech(tmp_path, "b", 4, corpus)
    assert full.step == resumed.step == 4
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = full.optimizer.adamw.state_dict(), resumed.optimizer.adamw.state_dict()
    for i in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])


def test_pretrain_hubert_cli_export_loads_into_jax(tmp_path, capsys):
    """pretrain-hubert --device cpu, WavLM-Large's config made tiny, with
    mixing; its --export-params .npz in the JAX model gives the port's
    logits; a second run with more updates resumes at the checkpoint."""
    corpus = _corpus(tmp_path)
    argv = ["pretrain-hubert", "--manifest", str(corpus / "train.tsv"), "--labels",
            str(corpus / "train.km"), "--label-rate", "100", "--num-classes", "10",
            "--arch", "large", "--encoder-json", json.dumps(TINY), "--max-tokens", "48000",
            "--max-sample-size", "20000", "--min-sample-size", "8000", "--mixing-prob", "0.5",
            "--log-interval", "1", "--save-interval-updates", "2", "--checkpoint-dir",
            str(tmp_path / "ckpt"), "--export-params", str(tmp_path / "export.npz"),
            "--device", "cpu", "--unroll-layers", "--stacked-optimizer"]
    train_cli(argv + ["--max-updates", "2"])
    train_cli(argv + ["--max-updates", "3"])
    records = [json.loads(l) for l in capsys.readouterr().err.splitlines()
               if l.startswith('{"tag": "train"')]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss_avg"]) for r in records)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]

    enc = large_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                               dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0,
                               **dict(TINY, conv_layers=tuple(map(tuple,
                                                                  TINY["conv_layers"]))))
    cfg = HubertPretrainConfig(encoder=enc, num_classes=(10,), final_dim=768,
                               label_rate=100.0, time_mask=MaskConfig(mask_prob=0.8,
                                                                      mask_length=10))
    model = HubertPretrainModel(cfg)
    model.load_state_dict(torch.load(tmp_path / "ckpt" / "3" / "state.pt",
                                     weights_only=True)["model"])
    params = jax_load_params_npz(str(tmp_path / "export.npz"))
    jenc = jax_large_encoder_config(**dataclasses.asdict(enc))
    jmodel = JHubert(JHubertConfig(encoder=jenc, num_classes=(10,), final_dim=768,
                                   label_rate=100.0))
    rng = np.random.default_rng(9)
    source = rng.standard_normal((2, 12000)).astype(np.float32)
    lengths = np.asarray([12000, 9000], np.int32)
    T = enc.num_frames(12000)
    targets = rng.integers(0, 10, (2, T, 1)).astype(np.int32)
    jout = jmodel.apply({"params": params}, jnp.asarray(source), jnp.asarray(targets),
                        jnp.asarray(lengths), mask=False, deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(source), torch.from_numpy(targets),
                    torch.from_numpy(lengths), mask=False)
    for key in jout.logits:
        np.testing.assert_allclose(out.logits[key].numpy(), np.asarray(jout.logits[key]),
                                   rtol=1e-5, atol=1e-5)
    # the exported tree is the one the port's converter reads back
    back = hubert_state_dict_from_jax(params, cfg)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


def test_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    corpus = _corpus(tmp_path, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli(["pretrain-hubert", "--manifest", str(corpus / "train.tsv"), "--labels",
                   str(corpus / "train.km"), "--checkpoint-dir", str(tmp_path / "c")])
