"""The training loop: epoch-free updates with a validate/save cadence.

Counterpart of the JAX package's ``train/loop.py``. One process drives the
train step (``train/state.py``) on one device; batches come from an
epoch-checkpointable host iterator through a prefetch thread; checkpoints
are ``train/checkpoint.py``'s.

Determinism: the generator of the dispatch that starts at update ``u`` is
seeded from (seed, u), and a checkpoint stores a data state from which the
resumed run draws exactly the batches the uninterrupted run has yet to
train on. That is not the iterator's own state: the prefetch thread reads
ahead of the loop, and with ``accum_steps`` or ``inner_steps`` above 1
``group_microbatches`` holds drawn batches in a buffer per shape until
their group fills. So the loop numbers every draw, and a checkpoint stores
the data state from before the oldest draw not yet trained on, with the
later draws that were (``skip``), which the resumed run draws again and
drops. A run resumed from a checkpoint therefore repeats the uninterrupted
run exactly, on the CPU. Tensor parallelism and FSDP (``n_model > 1``,
``fsdp``) wait for the port of ``parallel/``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from unispeech_tpu_torch.convert.from_jax import jax_params_of, save_params_npz
from unispeech_tpu_torch.data.prefetch import prefetch
from unispeech_tpu_torch.train.checkpoint import CheckpointManager
from unispeech_tpu_torch.train.optim import OptimConfig
from unispeech_tpu_torch.train.state import TrainState, create_train_state, make_train_step
from unispeech_tpu_torch.utils.debug import HangWatchdog, nonfinite_paths
from unispeech_tpu_torch.utils.metrics import MetricsAggregator, ProgressLogger, StopwatchMeter

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class LoopConfig:
    max_updates: int = 400_000
    log_interval: int = 100
    save_interval_updates: int = 25_000
    # flat-.npz params export in the JAX package's layout at the end
    export_params: Optional[str] = None
    validate_interval_updates: int = 25_000
    max_valid_steps: int = 0  # 0 = full pass
    keep_last_checkpoints: int = 3
    checkpoint_dir: str = "checkpoints"
    best_metric: str = "loss_avg"
    maximize_best: bool = False
    seed: int = 1
    # mesh (not ported: anything but 1 / False raises)
    n_model: int = 1
    fsdp: bool = False
    tensorboard_dir: Optional[str] = None
    wandb_project: Optional[str] = None
    azureml: bool = False
    accum_steps: int = 1  # gradient accumulation (microbatches per update)
    # optimizer steps per dispatch, each on its own batch; cadences fire
    # when crossed, and the loop may overshoot max_updates by < inner_steps
    inner_steps: int = 1
    prefetch_depth: int = 4  # batches collated ahead on a thread; 0 disables
    # check the logged loss every log interval and name non-finite params
    detect_nonfinite: bool = True
    # dump all thread stacks when a step takes longer than this; 0 disables
    hang_timeout_s: float = 0.0
    hang_kill: bool = False

    def __post_init__(self):
        if self.n_model > 1 or self.fsdp:
            raise NotImplementedError("tensor parallelism and FSDP (parallel/) are not "
                                      "ported to PyTorch yet")


def update_generator(seed: int, update: int) -> torch.Generator:
    """The CPU generator of the dispatch that starts at ``update``."""
    state = np.random.SeedSequence([seed, update]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


DRAW_KEY = "_draw"  # the draw number each batch carries through the loop's grouping


def _number_draws(batches: Iterable[Dict], data_obj, states: Dict, skip) -> Iterator[Dict]:
    """Each batch with its draw number under ``DRAW_KEY`` (stacked along
    with the batch by ``group_microbatches``), dropping the draws numbered
    in ``skip``. ``states[i]`` is the data state from before draw ``i``; it
    is written before draw ``i - 1`` is handed on. Runs on the thread that
    draws the batches."""
    def data_now():
        return data_obj.state_dict() if data_obj is not None else None

    states[0] = data_now()
    for i, b in enumerate(batches):
        states[i + 1] = data_now()
        if i not in skip:
            yield {**b, DRAW_KEY: np.asarray(i)}


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def run_training(
    model: torch.nn.Module,
    loss_fn,  # (batch, generator, step) -> (loss_sum, sample_size, metrics)
    optimizer_cfg: OptimConfig,
    train_batches: Iterable[Dict[str, np.ndarray]],  # infinite iterator
    cfg: LoopConfig,
    device="cuda",
    valid_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
    eval_loss_fn=None,  # as loss_fn, run without gradients
    valid_decode_fn=None,  # (state, batch) -> {metric: sum} (e.g. WER sums)
    data_state=None,  # the iterator, with state_dict / load_state_dict
) -> TrainState:
    """Train ``model`` (moved to ``device``; default the card) from the
    latest checkpoint in ``cfg.checkpoint_dir``, if any, to
    ``cfg.max_updates``; returns the final state."""
    state = create_train_state(model, optimizer_cfg, device=device)
    device = next(model.parameters()).device
    ckpt = CheckpointManager(cfg.checkpoint_dir, keep_last=cfg.keep_last_checkpoints,
                             best_metric=cfg.best_metric, maximize_best=cfg.maximize_best)
    restored_data, num_updates = ckpt.restore(state)
    skip = set()
    if restored_data is not None and data_state is not None:
        data_state.load_state_dict(restored_data["iterator"])
        skip = set(restored_data["skip"])
    # draws below `oldest` were all trained on; `consumed` holds those above
    states: Dict = {}
    oldest, consumed = 0, set(skip)
    data_snapshot = {"iterator": data_state.state_dict() if data_state is not None else None,
                     "skip": sorted(skip)}

    step_fn = make_train_step(loss_fn, accum_steps=cfg.accum_steps,
                              inner_steps=cfg.inner_steps)
    train_batches = _number_draws(train_batches, data_state, states, skip)
    if cfg.accum_steps > 1:
        train_batches = group_microbatches(train_batches, cfg.accum_steps)
    if cfg.inner_steps > 1:
        # each dispatch takes (inner_steps, [accum,] ...)
        train_batches = group_microbatches(train_batches, cfg.inner_steps)
    if cfg.prefetch_depth > 0:
        train_batches = prefetch(train_batches, depth=cfg.prefetch_depth)

    agg = MetricsAggregator()
    sinks = dict(wandb_project=cfg.wandb_project, azureml=cfg.azureml)
    train_log = ProgressLogger("train", cfg.tensorboard_dir, **sinks)
    valid_log = ProgressLogger("valid", cfg.tensorboard_dir, **sinks)
    timer = StopwatchMeter()
    hang = HangWatchdog(cfg.hang_timeout_s, kill=cfg.hang_kill) if cfg.hang_timeout_s > 0 \
        else None

    # the metrics of the latest validation go with the first save after it
    # only, so an unvalidated checkpoint never ties the best on a stale score
    pending_val_metrics: Optional[Dict[str, float]] = None
    k_steps = cfg.inner_steps
    try:
        for batch in train_batches:
            if num_updates >= cfg.max_updates:
                break
            draws = batch.pop(DRAW_KEY)
            device_batch = _to_device(batch, device)
            timer.start()
            if hang is not None:
                hang.arm()
            metrics = step_fn(state, device_batch, update_generator(cfg.seed, num_updates))
            timer.stop()
            num_updates += k_steps
            consumed.update(np.ravel(draws).tolist())
            while oldest in consumed:
                consumed.remove(oldest)
                del states[oldest]
                oldest += 1
            data_snapshot = {"iterator": states[oldest],
                             "skip": sorted(i - oldest for i in consumed)}
            # reading the metrics waits for the step: the watchdog's window
            # covers the device's work
            if k_steps > 1:
                for k in range(k_steps):
                    agg.update({n: m[k] for n, m in metrics.items()})
            else:
                agg.update(metrics)
            if hang is not None:
                hang.disarm()

            if _crossed(num_updates, k_steps, cfg.log_interval):
                stats = agg.snapshot()
                stats["updates"] = num_updates
                stats["step_time_avg_s"] = timer.avg
                train_log.log(num_updates, stats)
                agg.reset()
                if cfg.detect_nonfinite and not np.isfinite(stats.get("loss_avg", 0.0)):
                    bad = nonfinite_paths(state.model.state_dict())
                    detail = "; ".join(f"{p}:{k}" for p, k in bad) or "params finite"
                    raise FloatingPointError(
                        f"non-finite training loss at update {num_updates} "
                        f"({stats.get('loss_avg')}); {detail}")

            if (cfg.validate_interval_updates and valid_batches_fn is not None
                    and eval_loss_fn is not None
                    and _crossed(num_updates, k_steps, cfg.validate_interval_updates)):
                vstats = run_validation(state, eval_loss_fn, valid_batches_fn(),
                                        cfg.max_valid_steps, decode_fn=valid_decode_fn)
                valid_log.log(num_updates, vstats)
                if cfg.best_metric in vstats:
                    pending_val_metrics = {cfg.best_metric: float(vstats[cfg.best_metric])}

            if cfg.save_interval_updates and _crossed(num_updates, k_steps,
                                                      cfg.save_interval_updates):
                ckpt.save(num_updates, state, data_state=data_snapshot,
                          metrics=pending_val_metrics)
                pending_val_metrics = None
    finally:
        if hasattr(train_batches, "close"):
            train_batches.close()
        train_log.close()
        valid_log.close()
    ckpt.save(num_updates, state, data_state=data_snapshot, metrics=pending_val_metrics)
    if cfg.export_params:
        save_params_npz(cfg.export_params, jax_params_of(state.model))
    return state


def _crossed(num_updates: int, k_steps: int, interval: int) -> bool:
    """Did the last dispatch (which advanced by k_steps) cross a multiple of
    interval? With k_steps == 1 this is exactly num_updates % interval == 0."""
    return (num_updates // interval) > ((num_updates - k_steps) // interval)


def group_microbatches(batches: Iterable[Dict], k: int) -> Iterator[Dict]:
    """Stack k consecutive same-shape batches into one (k, ...) batch.

    Batches are buffered per shape, so a stream of several bucket shapes
    still groups; each batch out carries a leading (k, ...) axis. When a
    finite stream ends, the groups that never filled are reported and
    dropped."""
    buffers: Dict = {}
    for b in batches:
        key = tuple(sorted((name, v.shape) for name, v in b.items()))
        buf = buffers.setdefault(key, [])
        buf.append(b)
        if len(buf) == k:
            yield {name: np.stack([mb[name] for mb in buf]) for name in buf[0]}
            buffers[key] = []
    n_dropped = sum(len(buf) for buf in buffers.values())
    if n_dropped:
        logger.warning(
            "group_microbatches: dropped %d tail micro-batch(es) across %d bucket shape(s) "
            "that never filled an accumulation group of %d",
            n_dropped, sum(1 for buf in buffers.values() if buf), k)


def run_validation(state: TrainState, eval_loss_fn, batches, max_steps: int = 0,
                   decode_fn=None) -> Dict:
    """Aggregated eval-loss metrics and, with ``decode_fn(state, batch) ->
    {metric: sum}``, decode-and-score sums whose ratios (wer, uer) are
    derived at the end. The eval generator is seeded 0."""
    agg = MetricsAggregator()
    agg.add_derived("wer", lambda s: 100.0 * s["wer_errs"] / max(s["wer_len"], 1))
    agg.add_derived("uer", lambda s: 100.0 * s["uer_errs"] / max(s["uer_len"], 1))
    device = next(state.model.parameters()).device
    for i, batch in enumerate(batches):
        if max_steps and i >= max_steps:
            break
        device_batch = _to_device(batch, device)
        with torch.no_grad():
            _, _, metrics = eval_loss_fn(device_batch, torch.Generator().manual_seed(0),
                                         state.step)
        metrics = dict(metrics)
        if decode_fn is not None:
            metrics.update(decode_fn(state, device_batch))
        agg.update(metrics)
    return agg.snapshot()
