"""DeepSpeedEngine: the training engine on one card.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` on the path a GPT-2
run takes: ``forward`` / ``backward`` / ``step`` driven by an unchanged
ds_config, ``train_batch``, gradient accumulation, clipping, bf16 and fp16
(dynamic loss scaling with overflow skip), the LR schedules, and
checkpoints in the JAX package's layout and format.

- Precision: the module's parameters are the fp32 master weights. With
  bf16 or fp16 enabled every floating parameter is cast to that dtype at
  each call (``torch.func.functional_call`` over the cast copies), as the
  JAX engine casts its parameter tree before ``apply``; gradients flow back
  through the casts into fp32 ``.grad``.
- ``forward`` runs the module (dropout on while training, its masks seeded
  from the engine's ``torch.Generator``) and returns the loss;
  ``backward(loss)`` backpropagates ``loss * loss_scale / gas``, adding into
  ``.grad``; ``step`` at a gradient-accumulation boundary unscales, skips on
  fp16 overflow, clips, runs ``adam_update`` and steps the scheduler.
- ``train_batch`` is forward, backward and step, eagerly. (The JAX package
  fuses them into one program; a CUDA graph of the step is later work.)
- Checkpoints: ``<dir>/<tag>/mp_rank_00_model_states.pt``, a pickle of
  numpy arrays under the flax names, plus the ``latest`` file; a checkpoint
  of either package loads in the other.
- Telemetry, as in the JAX engine: one ``MetricsRegistry``
  (``self.telemetry``) with the ``global_steps``, ``global_samples``,
  ``skipped_steps`` and ``lr`` gauges and the throughput timer's
  ``samples_per_sec``; ``wall_clock_breakdown`` times forward, backward
  (``backward_inner``: the autograd call alone) and step, each interval
  bracketed by ``torch.cuda.synchronize()`` and observed into the
  ``timer_seconds`` histograms, and logs them every ``steps_per_print``
  steps (with ``memory_breakdown``, the allocator's current and peak
  bytes); the ``tensorboard`` block writes per-step scalars and the
  registry through ``telemetry.TensorBoardScalarWriter``, a warn-once
  no-op where the ``tensorboard`` package is missing. The throughput
  timer synchronizes only when its timing begins and at each
  ``steps_per_print`` report, not at every step as the JAX (and the
  reference's) timer does (``utils/timer.ThroughputTimer``).

Not on this path yet (ROADMAP Queue 1): the dataloader (``training_data``),
ZeRO and offload, Lamb and 1-bit Adam, pipeline.
"""

import inspect
import logging
import os
import pickle
import weakref

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.config import (ADAM_OPTIMIZER,
                                                ADAMW_OPTIMIZER,
                                                DeepSpeedConfig)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler
from deepspeed_tpu_torch.runtime.utils import (clip_grad_norm_,
                                               ensure_directory_exists,
                                               flax_tree, has_overflow,
                                               load_flax_tree)
from deepspeed_tpu_torch.telemetry import (MetricsRegistry,
                                           TensorBoardScalarWriter)
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

logger = logging.getLogger(__name__)

_DEEPSPEED_STATES = (
    "module", "optimizer", "lr_scheduler", "csr_tensor_module_names",
    "skipped_steps", "global_steps", "global_samples", "dp_world_size",
    "mp_world_size", "loss_scaler")


def _nest(names, tensors):
    """{"a.b": t} -> {"a": {"b": numpy}}: a flax-shaped tree of arrays."""
    tree = {}
    for name, t in zip(names, tensors):
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


class DeepSpeedEngine(object):
    """The training engine (module docstring). ``model`` is a
    ``torch.nn.Module`` whose forward returns the loss (or a tuple whose
    first element is the loss); ``model_parameters`` may be a flax
    parameter tree of numpy arrays to load into it."""

    def __init__(self, args, model, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, config_params=None,
                 device=None, seed=1234):
        if training_data is not None:
            raise NotImplementedError(
                "training_data: the dataloader (deepspeed_io) comes with a "
                "later slice (ROADMAP Queue 1); pass batches to train_batch "
                "or forward")
        self.device = resolve_device(device)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training = True
        self.training_dataloader = None
        self._config = self._configure_with_arguments(args, config_params)
        self._tb_writer = None
        self._last_loss = None
        # Telemetry (module docstring): the phase timers observe into the
        # registry, and the gauges read the engine's state at scrape time.
        self.telemetry = MetricsRegistry(engine="training")
        self.timers = SynchronizedWallClockTimer(registry=self.telemetry)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(), num_workers=1,
            steps_per_output=self.steps_per_print(), monitor_memory=False,
            registry=self.telemetry)
        # Through a weak reference: a dropped engine (its parameters and
        # optimizer state) is freed at once, not by the cycle collector.
        ref = weakref.ref(self)
        self.telemetry.gauge("global_steps").set_fn(
            lambda: ref().global_steps)
        self.telemetry.gauge("global_samples").set_fn(
            lambda: ref().global_samples)
        self.telemetry.gauge("skipped_steps").set_fn(
            lambda: ref().skipped_steps)
        self.telemetry.gauge("lr").set_fn(
            lambda: (ref().get_lr() if ref().optimizer else [0.0])[0])

        if self.fp16_enabled():
            self.compute_dtype = torch.float16
        elif self.bfloat16_enabled():
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32

        self.module = model.to(self.device)
        if isinstance(model_parameters, dict):
            if set(model_parameters) == {"params"}:
                model_parameters = model_parameters["params"]
            load_flax_tree(self.module, model_parameters)
        named = [(n, p) for n, p in self.module.named_parameters()]
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        for p in self._params:
            p.requires_grad_(True)
        accepted = inspect.signature(self.module.forward).parameters
        self._takes_deterministic = "deterministic" in accepted
        self._takes_generator = "generator" in accepted
        # Dropout seeds come from here (a CPU generator: drawing a seed
        # never waits for the card).
        self._generator = torch.Generator()
        self._generator.manual_seed(seed)

        self.loss_scaler = None
        if self.fp16_enabled():
            self.loss_scaler = CreateLossScaler(
                dynamic_scaling=self._config.loss_scale == 0,
                static_loss_scale=self._config.loss_scale or 1.0,
                dynamic_loss_args=self._config.dynamic_loss_scale_args)
        self._configure_optimizer(optimizer)
        self._configure_lr_scheduler(lr_scheduler)

    # ------------------------------------------------------------- config

    def _configure_with_arguments(self, args, config_params):
        config_file = getattr(args, "deepspeed_config", None) if args \
            else None
        if config_file is None and config_params is None:
            raise ValueError("DeepSpeed requires --deepspeed_config or "
                             "config_params")
        if config_file is not None and config_params is not None:
            raise ValueError("pass exactly one of a deepspeed_config file and "
                             "a config_params dict")
        if config_file is not None and not os.path.isfile(config_file):
            raise FileNotFoundError("DeepSpeed config file not found: "
                                    "{}".format(config_file))
        return DeepSpeedConfig(config_file, param_dict=config_params)

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def sparse_attention(self):
        return self._config.sparse_attention

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def memory_breakdown(self):
        return self._config.memory_breakdown

    def tensorboard_enabled(self):
        return self._config.tensorboard_enabled

    def tensorboard_output_path(self):
        return self._config.tensorboard_output_path

    def tensorboard_job_name(self):
        return self._config.tensorboard_job_name

    def _tensorboard_log_dir(self, name="DeepSpeedJobName", base=None):
        """Event-file directory: ``<output_path>/<job_name>``, or under
        ``base`` (default ``~/tensorboard``) and the $DLWS/DLTS job id."""
        if self.tensorboard_output_path():
            return os.path.join(self.tensorboard_output_path(),
                                self.tensorboard_job_name() or name)
        summary_writer_dir_name = (self.tensorboard_job_name() or name)
        if base is None:
            base = os.path.join(os.path.expanduser("~"), "tensorboard")
        if "DLWS_JOB_ID" in os.environ:
            infra_job_id = os.environ["DLWS_JOB_ID"]
        elif "DLTS_JOB_ID" in os.environ:
            infra_job_id = os.environ["DLTS_JOB_ID"]
        else:
            infra_job_id = "unknown-job-id"
        return os.path.join(base, infra_job_id, summary_writer_dir_name)

    def _scalar_writer(self, name="DeepSpeedJobName", base=None):
        """The lazy ``telemetry.TensorBoardScalarWriter`` behind the
        ``tensorboard`` block: a warn-once no-op without the tensorboard
        package, so training never stops over an exporter."""
        if self._tb_writer is None:
            self._tb_writer = TensorBoardScalarWriter(
                self._tensorboard_log_dir(name=name, base=base))
        return self._tb_writer

    def get_summary_writer(self, name="DeepSpeedJobName", base=None):
        """The raw SummaryWriter (the reference's API); raises where the
        tensorboard package is unavailable."""
        writer = self._scalar_writer(name=name, base=base)._get()
        if writer is None:
            raise RuntimeError(
                "tensorboard is unavailable (torch.utils.tensorboard "
                "failed to import or the log dir is unwritable)")
        return writer

    def _tensorboard_step_events(self):
        """Per-step scalars (train loss, lr and the loss scale at each
        boundary step, against global_samples) and the registry snapshot
        (phase-timer percentiles, samples/sec, the step gauges) under
        ``telemetry/``."""
        if not self.tensorboard_enabled():
            return
        tb = self._scalar_writer()
        if not tb.available:  # warned once inside the writer
            return
        if self._last_loss is not None:
            tb.add_scalar("Train/Samples/train_loss", float(self._last_loss),
                          self.global_samples)
        if self.optimizer is not None:
            tb.add_scalar("Train/Samples/lr", self.get_lr()[0],
                          self.global_samples)
        if self.loss_scaler is not None:
            tb.add_scalar("Train/Samples/loss_scale",
                          self.loss_scaler.loss_scale, self.global_samples)
        tb.publish(self.telemetry, self.global_samples)
        tb.flush()

    def _report_progress(self, step):
        """The ``steps_per_print`` line, read from the telemetry registry:
        the gauges Prometheus and TensorBoard export."""
        snap = self.telemetry.snapshot()
        logger.info("step={}, skipped={}, lr={}, mom={}, samples={}, "
                    "samples/sec={:.2f}".format(
                        step, self.skipped_steps, self.get_lr(),
                        self.get_mom(), int(snap.get("global_samples", 0)),
                        snap.get("samples_per_sec", 0.0)))

    def _configure_optimizer(self, client_optimizer):
        self.optimizer = client_optimizer
        if client_optimizer is None and \
                self._config.optimizer_name is not None:
            params = dict(self._config.optimizer_params or {})
            params.pop("torch_adam", None)
            adam_w_mode = params.pop(
                "adam_w_mode", self._config.optimizer_name == ADAMW_OPTIMIZER)
            if self._config.optimizer_name not in (ADAM_OPTIMIZER,
                                                   ADAMW_OPTIMIZER):
                raise ValueError("Unknown optimizer: {}".format(
                    self._config.optimizer_name))
            self.optimizer = FusedAdam(
                params=self._params,
                adam_w_mode=adam_w_mode or
                self._config.optimizer_name == ADAMW_OPTIMIZER, **params)
        self.opt_state = None
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init_state(self._params)

    def _configure_lr_scheduler(self, client_lr_scheduler):
        name = self._config.scheduler_name
        if name is not None and self.optimizer is not None:
            scheduler = getattr(lr_schedules, name, None)
            if scheduler is None:
                raise ValueError("DeepSpeed does not recognize LR scheduler "
                                 "{}".format(name))
            self.lr_scheduler = scheduler(self.optimizer,
                                          **(self._config.scheduler_params
                                             or {}))
        elif callable(client_lr_scheduler) and self.optimizer is not None:
            self.lr_scheduler = client_lr_scheduler(self.optimizer)
        else:
            self.lr_scheduler = client_lr_scheduler

    # ------------------------------------------------------------ forward

    def train(self, mode=True):
        self.training = mode

    def eval(self):
        self.training = False

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return x

    def _run_module(self, inputs, kwargs):
        if self.compute_dtype == torch.float32:
            return self.module(*inputs, **kwargs)
        cast = {n: p.to(self.compute_dtype) if p.is_floating_point() else p
                for n, p in zip(self._names, self._params)}
        return torch.func.functional_call(self.module, cast, inputs, kwargs)

    def forward(self, *inputs, **kwargs):
        """Run the module on ``inputs`` (numpy arrays or tensors, moved to
        the engine's device) and return its loss. While training, dropout
        is on and the graph is kept for ``backward``."""
        if self.wall_clock_breakdown():
            self.timers("forward_microstep").start()
            self.timers("forward").start()
        inputs = tuple(self._to_device(x) for x in inputs)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        if not self.training:
            with torch.no_grad():
                out = self._run_module(inputs, kwargs)
        else:
            self.tput_timer.start()
            if self._takes_deterministic:
                kwargs.setdefault("deterministic", False)
            if self._takes_generator:
                kwargs.setdefault("generator", self._generator)
            out = self._run_module(inputs, kwargs)
        if self.wall_clock_breakdown():
            self.timers("forward").stop()
            self.timers("forward_microstep").stop()
        return out[0] if isinstance(out, tuple) else out

    # ----------------------------------------------------------- backward

    def backward(self, loss):
        """Add the gradients of ``loss * loss_scale /
        gradient_accumulation_steps`` into the parameters' ``.grad``."""
        if not loss.requires_grad:
            raise RuntimeError("backward() needs the loss of a training "
                               "forward()")
        self._last_loss = loss.detach()
        breakdown = self.wall_clock_breakdown()
        if breakdown:
            self.timers("backward_microstep").start()
            self.timers("backward").start()
            self.timers("backward_inner").start()
        scale = self.loss_scaler.loss_scale if self.loss_scaler else 1.0
        (loss * (scale / self.gradient_accumulation_steps())).backward()
        if breakdown:
            self.timers("backward_inner").stop()
            self.timers("backward").stop()
            self.timers("backward_microstep").stop()
        return loss

    # --------------------------------------------------------------- step

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def zero_grad(self):
        for p in self._params:
            p.grad = None

    def get_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def set_lr(self, lr):
        for g in self.optimizer.param_groups:
            g["lr"] = lr

    def get_mom(self):
        return [g.get("betas", (0.0, 0.0))[0]
                for g in self.optimizer.param_groups]

    @torch.no_grad()
    def _take_model_step(self, lr_kwargs=None):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        overflow = False
        cur_scale = 1.0
        if self.loss_scaler is not None:
            cur_scale = self.loss_scaler.loss_scale
            overflow = bool(has_overflow(grads))
            self.loss_scaler.update_scale(overflow)
        if overflow:
            self.skipped_steps += 1
            logger.info("OVERFLOW! Skipping step. Attempted loss scale: {}, "
                        "reducing to {}".format(cur_scale,
                                                self.loss_scaler.loss_scale))
        else:
            if cur_scale != 1.0:
                torch._foreach_mul_(grads, 1.0 / cur_scale)
            if self.gradient_clipping() > 0.0:
                clip_grad_norm_(grads, self.gradient_clipping())
            group = self.optimizer.param_groups[0]
            self.optimizer.update(self._params, grads, self.opt_state,
                                  lr=group["lr"],
                                  betas=group.get("betas", (0.9, 0.999)))
            if self.lr_scheduler is not None:
                self.lr_scheduler.step(**(lr_kwargs or {}))
            if (self.global_steps + 1) % self.steps_per_print() == 0:
                self._report_progress(self.global_steps + 1)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.zero_grad()
        self._tensorboard_step_events()

    def step(self, lr_kwargs=None):
        """The weight update, at gradient-accumulation boundaries."""
        if self.optimizer is None:
            raise RuntimeError("must provide an optimizer during init in "
                               "order to use step")
        breakdown = self.wall_clock_breakdown()
        if breakdown:
            self.timers("step_microstep").start()
            self.timers("step").start()
        boundary = self.is_gradient_accumulation_boundary()
        if boundary:
            self._take_model_step(lr_kwargs)
        self.tput_timer.stop()
        if breakdown:
            self.timers("step").stop()
            self.timers("step_microstep").stop()
            if boundary and self.global_steps % self.steps_per_print() == 0:
                self.timers.log(["forward_microstep", "backward_microstep",
                                 "step_microstep"],
                                memory_breakdown=self.memory_breakdown())
        self.micro_steps += 1

    def train_batch(self, batch=None, data_iter=None):
        """forward, backward and step on one micro-batch (a tuple of inputs
        or one input). Returns the loss, detached."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or a data_iter")
            batch = next(data_iter)
        loss = self.forward(*batch) if isinstance(batch, (tuple, list)) \
            else self.forward(batch)
        self.backward(loss)
        self.step()
        return loss.detach()

    # --------------------------------------------------------- checkpoint

    def _get_ckpt_name(self, checkpoints_path, tag):
        return os.path.join(checkpoints_path, str(tag),
                            "mp_rank_00_model_states.pt")

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write ``<save_dir>/<tag>/mp_rank_00_model_states.pt`` (a pickle of
        numpy arrays under the flax names, as the JAX package writes it) and
        the ``latest`` file."""
        if tag is None:
            tag = "global_step{}".format(self.global_steps)
        save_path = self._get_ckpt_name(save_dir, tag)
        ensure_directory_exists(save_path)
        optimizer = None
        if self.optimizer is not None:
            optimizer = {"state": {
                "step": np.asarray(self.opt_state["step"], np.int32),
                "exp_avg": _nest(self._names, self.opt_state["exp_avg"]),
                "exp_avg_sq": _nest(self._names,
                                    self.opt_state["exp_avg_sq"])}}
            optimizer.update(self.optimizer.state_dict())
        state = {
            "module": flax_tree(self.module),
            "optimizer": optimizer,
            "lr_scheduler": self.lr_scheduler.state_dict()
            if self.lr_scheduler is not None else None,
            "csr_tensor_module_names": [],
            "skipped_steps": self.skipped_steps,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "dp_world_size": 1,
            "mp_world_size": 1,
            "loss_scaler": self.loss_scaler.__dict__.copy()
            if self.loss_scaler is not None else None,
        }
        if client_state is not None:
            state.update(client_state)
        with open(save_path, "wb") as f:
            pickle.dump(state, f)
        if save_latest:
            with open(os.path.join(save_dir, "latest"), "w") as fd:
                fd.write(str(tag))
        return True

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Load a checkpoint written by either package. Returns (load path,
        client state), or (None, None) when there is none. The file is a
        pickle: load only checkpoints this program or the JAX package
        wrote."""
        if tag is None:
            latest_path = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest_path):
                logger.warning("Unable to find latest file at %s",
                               latest_path)
                return None, None
            with open(latest_path, "r") as fd:
                tag = fd.read().strip()
        load_path = self._get_ckpt_name(load_dir, tag)
        if not os.path.exists(load_path):
            logger.warning("checkpoint %s does not exist", load_path)
            return None, None
        with open(load_path, "rb") as f:
            checkpoint = pickle.load(f)

        load_flax_tree(self.module, checkpoint["module"])
        opt_sd = checkpoint.get("optimizer")
        if load_optimizer_states and self.optimizer is not None and \
                opt_sd is not None and opt_sd.get("state") is not None:
            saved = opt_sd["state"]
            for key in ("exp_avg", "exp_avg_sq"):
                for name, t in zip(self._names, self.opt_state[key]):
                    t.copy_(torch.from_numpy(
                        _leaf(saved[key], name).astype(np.float32)))
            self.opt_state["step"] = int(np.asarray(saved["step"]))
            self.optimizer.load_state_dict(opt_sd)
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                checkpoint.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(checkpoint["lr_scheduler"])
        if self.loss_scaler is not None and checkpoint.get("loss_scaler"):
            self.loss_scaler.__dict__.update(checkpoint["loss_scaler"])
        self.global_steps = checkpoint.get("global_steps", 0)
        self.global_samples = checkpoint.get(
            "global_samples", self.global_steps * self.train_batch_size())
        self.skipped_steps = checkpoint.get("skipped_steps", 0)
        self.micro_steps = \
            self.global_steps * self.gradient_accumulation_steps()
        client_state = {k: v for k, v in checkpoint.items()
                        if k not in _DEEPSPEED_STATES}
        return load_path, client_state
