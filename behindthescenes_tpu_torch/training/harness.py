"""Training harness: the run loop with validation, checkpoints, best-K,
resume and metric logging (counterpart of
behindthescenes_tpu/training/harness.py:44-413; reference
utils/base_trainer.py:24-518).

The loop is plain code, its events in the JAX package's order: NaN stop,
log, checkpoint, validate and keep the best, visualise, SIGTERM stop,
`stop_iteration`; epoch-end validation when `eval_use_iters` is false.
The step counter counts micro-steps and carries on across a resume, while
the epoch loop starts again, as in the JAX harness.

Checkpoints are the port's own: a step directory `<dir>/<step>/` holds
`state.pt` (torch.save of `BTSTrainer.state_dict()`: parameters,
BatchNorm statistics, Adam's state, the accumulated gradient and the
counters), `<dir>/extra_<step>.json` the render scheduler, and the newest
`max_to_keep` steps are kept. The JAX package's orbax step directories
(`<step>/default/`) are not read here: tools/orbax_to_port.py turns one
into a step directory of the port (`state_from_jax`), and the run then
resumes from it.

Under a trainer of several ranks (data parallel, `BTSTrainer.group`)
every rank runs the loop on its own loader and restores the same
checkpoint; rank 0 alone writes checkpoints, best steps and
`best_value.json`, and alone visualises. A state holds no trace of the
world size, so a run saved at one resumes at another. Validation sums
each metric's (total, count) over the ranks before it divides, so every
rank logs the same means, and a SIGTERM stops every rank at the same
iteration (the flag is reduced where it is read: a stop that one rank
alone saw would leave the others waiting in their next collective).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.parallel.mesh import any_rank, barrier, sum_host
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.weights import (_to_torch_layout, flax_key,
                                               state_dict_from_flat)

log = logging.getLogger("bts_torch")

STATE_FILE = "state.pt"

# Set by SIGTERM: checkpoint and stop at the next iteration boundary.
_stop_requested = False


def _request_stop(signum, frame):  # noqa: ARG001 (signal handler ABI)
    global _stop_requested
    _stop_requested = True
    log.info("signal %d received — checkpointing and exiting at the next "
             "iteration boundary", signum)


class MeanMetric:
    """NaN-skipping running mean (reference utils/metrics.py:11-41)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        if np.isnan(value):
            return
        self.total += float(value)
        self.count += 1

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")


@dataclasses.dataclass
class HarnessConfig:
    """The run loop's settings, read from the task config's keys.

    `profile_dir`: iterations profile_steps[0] (included) to
    profile_steps[1] (left out) run under torch.profiler, whose trace is
    written there for TensorBoard, with the port's spans on
    (`behindthescenes_tpu_torch.tracing`: train_step and its stages,
    data_wait for the loader's wait); the port's counters over those
    iterations (kernel launches, host-to-device copies and bytes) are
    logged when the profiler stops."""
    output_path: str = "out/run"
    num_epochs: int = 1
    validate_every: int = 2000       # iterations
    visualize_every: int = 500
    checkpoint_every: int = 500
    log_every: int = 50
    stop_iteration: Optional[int] = None
    resume_from: Optional[str] = None
    save_best_metric: Optional[str] = None
    save_best_sign: int = -1          # -1: lower is better
    stop_on_nan_check_every: int = 0  # 1 = check every iteration
    debug_nans: bool = False          # autograd anomaly detection (slow)
    profile_dir: Optional[str] = None  # torch.profiler trace directory
    profile_steps: tuple = (10, 20)    # (start_iter, stop_iter)
    eval_use_iters: bool = True        # False: validate at epoch ends
    transfer_dtype: Optional[str] = None  # "bfloat16": images cross to the
    # card at half width and are cast back to f32 there

    @classmethod
    def from_conf(cls, conf: dict) -> "HarnessConfig":
        best = conf.get("save_best", {}) or {}
        return cls(
            output_path=conf.get("output_path", "out/run"),
            num_epochs=conf.get("num_epochs", 1),
            validate_every=conf.get("validate_every", 2000),
            visualize_every=conf.get("visualize_every", 500),
            checkpoint_every=conf.get("checkpoint_every", 500),
            log_every=conf.get("log_every_iters", 50),
            stop_iteration=conf.get("stop_iteration", None),
            resume_from=conf.get("resume_from", None),
            save_best_metric=best.get("metric"),
            save_best_sign=best.get("sign", -1),
            stop_on_nan_check_every=conf.get("stop_on_nan_check_every", 0),
            debug_nans=conf.get("debug_nans", False),
            profile_dir=conf.get("profile_dir", None),
            profile_steps=tuple(conf.get("profile_steps", (10, 20))),
            eval_use_iters=conf.get("eval_use_iters", True),
            transfer_dtype=conf.get("transfer_dtype", None),
        )


def _flatten(tree, prefix: str) -> dict:
    """A nested dict of arrays -> {prefix + slash-joined keys: a writable
    copy of the array}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.array(value)
    return out


def state_from_jax(tree: dict, trainer: BTSTrainer,
                   extra: Optional[dict] = None) -> dict:
    """The port's `BTSTrainer.state_dict()` of a JAX package's checkpoint,
    with numpy alone. `tree` is what the JAX `CheckpointManager` saves and
    `restore_replicated` returns (behindthescenes_tpu/training/harness.py:
    124-127), its leaves as arrays: params, batch_stats, step, and
    opt_state, optax's adam state list [{count, mu, nu}, {count}] (its
    schedule's), inside optax.MultiSteps' {mini_step, gradient_step,
    inner_opt_state, acc_grads} when the run accumulates. `trainer` (the
    port's, on the same config, after init_state) gives the parameters'
    names and order and the optimiser's groups; `extra` is the step's
    `extra_<step>.json` (the render scheduler), kept as it is.

    Parameters and BatchNorm statistics map through weights.torch_name;
    Adam's mu and nu become torch Adam's exp_avg and exp_avg_sq, its
    count the step of every parameter; MultiSteps' mini_step, gradient
    step and acc_grads become the port's mini_step, updates and
    acc_grads; `step` counts micro-steps on both sides."""
    flat = {**_flatten(tree["params"], "params/"),
            **_flatten(tree.get("batch_stats") or {}, "batch_stats/")}
    opt = tree["opt_state"]
    multi = isinstance(opt, dict) and "inner_opt_state" in opt
    adam = (opt["inner_opt_state"] if multi else opt)[0]
    count = int(np.asarray(adam["count"]))
    if multi != (trainer.accumulate_steps > 1):
        raise ValueError(f"the checkpoint's optimiser state "
                         f"{'has' if multi else 'has no'} optax.MultiSteps "
                         f"accumulator; the config's accumulate_steps is "
                         f"{trainer.accumulate_steps}")
    scales = trainer.net.encoder.scales
    mu = _flatten(adam["mu"], "params/")
    nu = _flatten(adam["nu"], "params/")
    acc = _flatten(opt["acc_grads"], "params/") if multi else None

    def port(moments, name):
        key, kind = flax_key(name, scales)
        return torch.from_numpy(np.ascontiguousarray(_to_torch_layout(
            moments[key].astype(np.float32, copy=False), kind)))

    optimizer = trainer.optimizer.state_dict()
    names = [n for n, _ in trainer.net.named_parameters()]
    optimizer["state"] = {} if count == 0 else {
        i: {"step": torch.tensor(float(count)), "exp_avg": port(mu, n),
            "exp_avg_sq": port(nu, n)} for i, n in enumerate(names)}
    updates = int(np.asarray(opt["gradient_step"])) if multi else count
    return {"net": state_dict_from_flat(flat), "optimizer": optimizer,
            "acc_grads": {n: port(acc, n) for n in names} if multi
            else None,
            "mini_step": int(np.asarray(opt["mini_step"])) if multi else 0,
            "updates": updates, "step": int(np.asarray(tree["step"])),
            "render_sched": (extra or {}).get(
                "render_sched", trainer.scheduler.state_dict())}


class CheckpointManager:
    """Step directories `<directory>/<step>/state.pt` of the trainer's
    state, the newest `max_to_keep` kept, and host-side extras
    (`extra_<step>.json`)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    @staticmethod
    def _is_step(path: str) -> bool:
        """Whether `path` holds a saved state; raises on an orbax step
        directory."""
        if os.path.exists(os.path.join(path, STATE_FILE)):
            return True
        if os.path.isdir(os.path.join(path, "default")):
            raise NotImplementedError(
                f"{path} is an orbax step directory of the JAX package, "
                "which the port does not read: convert it with "
                "tools/orbax_to_port.py (where jax and orbax are installed)")
        return False

    def all_steps(self) -> list:
        """The saved steps, in order."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and self._is_step(self.step_dir(d)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, trainer: BTSTrainer,
             extra: Optional[dict] = None) -> None:
        """Write step `step` (replacing one of that number), then drop the
        oldest steps beyond max_to_keep."""
        tmp = os.path.join(self.directory, f".tmp_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(trainer.state_dict(), os.path.join(tmp, STATE_FILE))
        final = self.step_dir(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if extra:
            with open(os.path.join(self.directory, f"extra_{step}.json"),
                      "w") as f:
                json.dump(extra, f)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(old))

    def load(self, step: Optional[int] = None) -> dict:
        """The saved state of `step` (default: the latest), on the host."""
        step = self.latest_step() if step is None else step
        if step is None or not self._is_step(self.step_dir(step)):
            raise FileNotFoundError(f"no checkpoint {step} in "
                                    f"{self.directory}")
        return torch.load(os.path.join(self.step_dir(step), STATE_FILE),
                          map_location="cpu", weights_only=False)

    def restore(self, trainer: BTSTrainer, step: Optional[int] = None):
        """Load `step` (default: the latest) into the trainer. Returns
        (the step restored or None, its extras or None)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        trainer.load_state_dict(self.load(step))
        extra_path = os.path.join(self.directory, f"extra_{step}.json")
        extra = None
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return step, extra


def _device_batches(loader, device, transfer_dtype=None):
    """The loader's batches as tensors on `device`, the images cast on the
    host to `transfer_dtype` (a torch dtype name) when given. Copies to
    the card go from pinned memory without waiting, so they overlap the
    host's work until the step needs them."""
    dtype = getattr(torch, transfer_dtype) if transfer_dtype else None
    cuda = torch.device(device).type == "cuda"
    for batch in loader:
        moved = {}
        for k, v in batch.items():
            if v is None:
                continue
            t = torch.as_tensor(v)
            if k == "imgs" and dtype is not None:
                t = t.to(dtype)
            moved[k] = t.pin_memory().to(device, non_blocking=True) if cuda \
                else t.to(device)
        yield moved


def _setup_logging(rank: int = 0, world: int = 1):
    if not log.handlers:
        handler = logging.StreamHandler()
        tag = f" [rank {rank}/{world}]" if world > 1 else ""
        handler.setFormatter(logging.Formatter(
            f"%(asctime)s %(name)s{tag} %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        log.propagate = False


def base_training(config: dict, get_dataflow: Callable,
                  trainer: Optional[BTSTrainer] = None,
                  visualize: Optional[Callable] = None,
                  on_iteration: Optional[Callable] = None,
                  on_validation: Optional[Callable] = None,
                  mark: Optional[Callable[[str], None]] = None,
                  device=None) -> BTSTrainer:
    """The run loop (reference utils/base_trainer.py:24-221 condensed).

    get_dataflow(config) -> (train_loader, val_loader, vis_loader).
    on_iteration(it, trainer, loss_dict), on_validation(it, metrics) and
    visualize(trainer, vis_loader, it) are called as in the JAX harness.
    mark(point), where given, is called in each iteration at "wait" (the
    next batch asked for), "data" (it is on the device; the wait between
    is the span "data_wait"), the train step's own points ("encode" ...
    "optimizer"), and "checkpoint" after a checkpoint is written. For
    `profile_dir` see HarnessConfig. Returns the trainer.
    """
    hc = HarnessConfig.from_conf(config)
    os.makedirs(hc.output_path, exist_ok=True)
    trainer = trainer or BTSTrainer(config, device=device)
    group, main = trainer.group, trainer.rank == 0
    _setup_logging(trainer.rank, trainer.world)
    log.info("config: %s", json.dumps(
        {k: v for k, v in config.items() if not isinstance(v, dict)},
        default=str))
    if hc.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    train_loader, val_loader, vis_loader = get_dataflow(config)
    trainer.init_state()

    ckpt = CheckpointManager(os.path.join(hc.output_path, "checkpoints"))
    best_ckpt = CheckpointManager(os.path.join(hc.output_path, "best"),
                                  max_to_keep=2)
    # The best value persists beside the best checkpoints, so that a
    # resumed run goes on comparing against it.
    best_value = None
    best_value_path = os.path.join(hc.output_path, "best", "best_value.json")
    if hc.save_best_metric and os.path.exists(best_value_path):
        try:
            with open(best_value_path) as f:
                prev = json.load(f)
            if prev.get("metric") == hc.save_best_metric:
                best_value = prev["signed_value"]
                log.info("resuming best %s tracker at signed value %.5f",
                         hc.save_best_metric, best_value)
        except Exception:                           # noqa: BLE001
            pass

    global _stop_requested
    _stop_requested = False
    try:  # signal.signal works in the main thread only
        prev_sigterm = signal.signal(signal.SIGTERM, _request_stop)
    except ValueError:
        prev_sigterm = None

    source = CheckpointManager(hc.resume_from) if hc.resume_from else ckpt
    step, extra = source.restore(trainer)
    if step is None and hc.resume_from:
        raise FileNotFoundError(f"no checkpoint in {hc.resume_from}")
    if step is not None:
        if extra and "render_sched" in extra:
            trainer.scheduler.load_state_dict(extra["render_sched"])
        log.info("resumed from %s at step %d", source.directory,
                 trainer.step)

    def save(target, step):
        if main:
            target.save(step, trainer, extra={
                "render_sched": trainer.scheduler.state_dict()})
            log.info("checkpoint %d written to %s", step, target.directory)

    def stop_profile():
        nonlocal profiler
        profiler.stop()
        tracing.enable(False)
        profiler = None
        log.info("profiler trace written to %s; the port's counters over "
                 "it: %s", hc.profile_dir, tracing.counters())

    def finish(reason):
        if profiler is not None:
            stop_profile()
        if ckpt.latest_step() != it:  # don't save this step twice
            save(ckpt, it)
        barrier(group)  # the last checkpoint is whole before any returns
        if prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, prev_sigterm)
            except ValueError:
                pass
        log.info("stopping at iteration %d (%s), checkpoint saved", it,
                 reason)
        return trainer

    def validate_now():
        nonlocal best_value
        metrics = run_validation(trainer, val_loader)
        log.info("validation @ %d: %s", it,
                 {k: round(v, 5) for k, v in metrics.items()})
        if on_validation is not None:
            on_validation(it, metrics)
        if hc.save_best_metric and hc.save_best_metric in metrics:
            val = metrics[hc.save_best_metric] * hc.save_best_sign
            if best_value is None or val > best_value:
                best_value = val
                save(best_ckpt, it)
                try:
                    if main:
                        with open(best_value_path, "w") as f:
                            json.dump({"metric": hc.save_best_metric,
                                       "signed_value": best_value,
                                       "value": metrics[hc.save_best_metric],
                                       "step": int(it)}, f)
                except Exception:                   # noqa: BLE001
                    pass
                log.info("new best %s=%.5f @ %d", hc.save_best_metric,
                         metrics[hc.save_best_metric], it)

    profiler = None
    it = trainer.step
    t_iter = time.time()
    for epoch in range(hc.num_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        batches = _device_batches(train_loader, trainer.device,
                                  hc.transfer_dtype)
        while True:
            if hc.profile_dir and it == hc.profile_steps[0]:
                profiler = torch.profiler.profile(
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(
                        hc.profile_dir))
                tracing.reset()
                tracing.enable(True)
                profiler.start()
            if profiler is not None and it == hc.profile_steps[1]:
                stop_profile()
            if mark:
                mark("wait")
            with tracing.span("data_wait"):
                batch = next(batches, None)
            if batch is None:
                break
            if mark:
                mark("data")
            t_data = time.time() - t_iter

            loss_dict = trainer.train_step(batch, mark=mark)
            it += 1

            # TerminateOnNan (reference utils/base_trainer.py:261,317).
            if it % hc.log_every == 0 or hc.stop_on_nan_check_every == 1:
                loss_val = float(loss_dict.get("loss", 0.0))
                if not np.isfinite(loss_val):
                    save(ckpt, it)
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at iteration {it}; "
                        "checkpoint saved")

            if it % hc.log_every == 0:
                values = {k: float(v) for k, v in loss_dict.items()}
                log.info("epoch %d it %d loss %.5f (t_iter %.3fs t_data "
                         "%.3fs) %s", epoch, it,
                         values.get("loss", float("nan")),
                         time.time() - t_iter, t_data,
                         {k: round(v, 5) for k, v in values.items()})
            t_iter = time.time()

            if on_iteration is not None:
                on_iteration(it, trainer, loss_dict)

            if it % hc.checkpoint_every == 0:
                save(ckpt, it)
                if mark:
                    mark("checkpoint")

            if (val_loader is not None and hc.eval_use_iters
                    and it % hc.validate_every == 0):
                validate_now()

            if (main and vis_loader is not None and visualize is not None
                    and it % hc.visualize_every == 0):
                visualize(trainer, vis_loader, it)

            if any_rank(_stop_requested, group):
                return finish("SIGTERM")
            if hc.stop_iteration and it >= hc.stop_iteration:
                return finish("stop_iteration")

        # Epoch-end validation (reference eval_use_iters=False mode,
        # utils/base_trainer.py:98-110).
        if val_loader is not None and not hc.eval_use_iters:
            validate_now()

    return finish("num_epochs reached")


# The eval step's metrics (training/wrapper.py::compute_depth_metrics),
# the names that ranks reduce in one order.
VAL_METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def run_validation(trainer: BTSTrainer, val_loader) -> dict:
    """The means of the eval step's metrics over the validation set
    (reference utils/base_trainer.py:98-110), NaNs skipped. Every item
    draws from a generator seeded with 0, as the JAX harness evaluates
    every item with PRNGKey(0), so that validations of the same
    parameters agree. Under a trainer of several ranks, each rank's
    loader holds its share of the items, and each metric's total and
    count are summed over the ranks before the divide
    (behindthescenes_tpu/training/harness.py:395-445), so every rank
    returns the same means."""
    group = trainer.group
    metrics: dict[str, MeanMetric] = {}
    for batch in val_loader:
        gen = torch.Generator(device=trainer.device)
        gen.manual_seed(0)
        out = trainer.eval_step(batch, generator=gen)
        for k, v in out.get("metrics", {}).items():
            metrics.setdefault(k, MeanMetric()).update(float(v))
    if group is not None:
        unknown = set(metrics) - set(VAL_METRICS)
        if unknown:
            raise ValueError(f"metrics {sorted(unknown)} have no place in "
                             "the ranks' reduction")
        # (total, count, seen) of each name, summed over the ranks.
        sums = sum_host([x for k in VAL_METRICS for x in (
            (metrics[k].total, metrics[k].count, 1.0) if k in metrics
            else (0.0, 0.0, 0.0))], group)
        metrics = {}
        for i, k in enumerate(VAL_METRICS):
            total, count, seen = sums[3 * i:3 * i + 3]
            if seen:
                metrics[k] = MeanMetric()
                metrics[k].total, metrics[k].count = total, int(count)
    return {k: m.compute() for k, m in metrics.items()}
