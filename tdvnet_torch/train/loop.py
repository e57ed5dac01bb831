"""Train and eval steps and the epoch loop (port of `tdvnet/train/loop.py`).

- Adam (optax's defaults) with a StepLR schedule, its value set before each
  update from the update count, as optax's schedule reads its count;
- the lambda ramp `min(epoch, 10) * 0.1` on the refinement losses unless
  finetuning, n_iters 1 -> 2 at epoch 20;
- the non-finetune regime freezes the backbone's BatchNorm: eval mode in
  the forward, and its scale and bias take no gradient and stay out of the
  optimizer (optax's `set_to_zero` on those leaves);
- metrics logged as JSONL, and as tensorboard scalars where the package is
  installed;
- `TrainConfig.bf16_compute`: a bf16 model, its parameters, gradients and
  Adam's state fp32 (`create_state`); `remat`: the forward rerun in the
  backward (`remat_forward`); `grad_accum_steps` = k: `optax.MultiSteps`'
  running mean of k microbatches' gradients and one Adam update a k-th
  microstep (`Optimizer`), the schedule counting updates.

A training state is the model and its optimizer (`TrainState`); a step
updates both in place and returns the state, as the JAX step returns its
new state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from tdvnet_torch.config import Config, resolve_device
from tdvnet_torch.models.layers import recompute_mode
from tdvnet_torch.models.threedvnet import ThreeDVNet
from tdvnet_torch.weights import load_flax_into, to_flax_variables


def make_lr_schedule(lr: float, lr_step_epochs: int, gamma: float,
                     steps_per_epoch: int, step_offset: int = 0):
    """StepLR: lr * gamma^(epoch // lr_step) of the update count.
    `step_offset` shifts the schedule for warm starts, where a fresh
    optimizer counts from 0 but the run continues from a later epoch."""

    def sched(step):
        epoch = (step + step_offset) // max(steps_per_epoch, 1)
        return lr * gamma ** (epoch // lr_step_epochs)

    return sched


def backbone_bn_params(model: ThreeDVNet) -> List[str]:
    """Names of the backbone BatchNorm scales and biases: frozen when not
    finetuning, like the reference's `freeze_batchnorm`."""
    names = []
    for mod_name, mod in model.mvsnet.backbone.named_modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            for p_name, _ in mod.named_parameters(recurse=False):
                names.append(f"mvsnet.backbone.{mod_name}.{p_name}")
    return names


class Optimizer:
    """Adam over the trainable parameters with a schedule of the update
    count. optax updates every leaf each step: a parameter the loss did not
    reach gets a zero gradient here, so that its Adam moments decay and its
    step count stays the global one, as there.

    With `accum_steps` = k > 1 it is `optax.MultiSteps(adam, k)`: microstep
    n (from 0) folds each gradient into a running mean in fp32,
    acc + (g - acc) / (n + 1) (optax's form, `use_grad_mean`), and only the
    k-th calls Adam, on that mean; the other microsteps leave the
    parameters, the moments and the update count as they were. `step`
    returns whether it updated."""

    def __init__(self, params, sched: Callable[[int], float],
                 accum_steps: int = 1):
        self.params = list(params)
        self.sched = sched
        self.count = 0
        self.accum_steps = int(accum_steps)
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None
        self.adam = torch.optim.Adam(self.params, lr=sched(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum_steps > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, p in zip(self.acc, self.params):
                # a true division, as optax's: PyTorch's CUDA division by a
                # Python scalar multiplies by the reciprocal
                a.add_((p.grad - a) / torch.full((), n + 1.0, dtype=a.dtype,
                                                 device=a.device))
            self.mini_step = n + 1
            if self.mini_step < self.accum_steps:
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a
            self.mini_step, self.acc = 0, None
        for group in self.adam.param_groups:
            group["lr"] = self.sched(self.count)
        self.adam.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "accum_steps": self.accum_steps,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("accum_steps", 1) != self.accum_steps:
            raise ValueError(f"optimizer state of grad_accum_steps="
                             f"{sd.get('accum_steps', 1)}, this regime "
                             f"accumulates {self.accum_steps}")
        self.adam.load_state_dict(sd["adam"])
        self.count = int(sd["count"])
        self.mini_step = int(sd.get("mini_step", 0))
        acc = sd.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def make_optimizer(cfg: Config, model: ThreeDVNet, steps_per_epoch: int,
                   start_epoch: int = 0) -> Optimizer:
    """The training optimizer (the JAX package's `make_tx`): the regime's
    lr, step and gamma, the schedule offset by `start_epoch` for a warm
    start, gradient accumulation over `grad_accum_steps` microbatches. The
    schedule counts updates, ceil(steps_per_epoch / k) an epoch, as
    optax's inside `MultiSteps`. Sets `requires_grad` of the backbone
    BatchNorm's scale and bias (False unless finetuning) and leaves them
    out of the optimizer."""
    t = cfg.train
    lr = t.finetune_lr if t.finetune else t.lr
    step_e = t.finetune_lr_step if t.finetune else t.lr_step
    gamma = t.finetune_lr_gamma if t.finetune else t.lr_gamma
    updates_per_epoch = -(-steps_per_epoch // t.grad_accum_steps)
    sched = make_lr_schedule(lr, step_e, gamma, updates_per_epoch,
                             step_offset=start_epoch * updates_per_epoch)
    frozen = set() if t.finetune else set(backbone_bn_params(model))
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(name not in frozen)
        if name not in frozen:
            params.append(p)
    return Optimizer(params, sched, t.grad_accum_steps)


@dataclasses.dataclass
class TrainState:
    model: ThreeDVNet
    optimizer: Optimizer


def create_state(cfg: Config, steps_per_epoch: int = 100, device=None,
                 start_epoch: int = 0) -> TrainState:
    """A fresh model (weights drawn from `cfg.train.seed`) on `device` (the
    card unless named) and its optimizer. With `bf16_compute` the model
    computes in bf16 (`ModelConfig.dtype`); its parameters stay fp32."""
    dev = resolve_device(device)
    torch.manual_seed(cfg.train.seed)
    mcfg = cfg.model
    if cfg.train.bf16_compute:
        mcfg = dataclasses.replace(mcfg, dtype=torch.bfloat16)
    model = ThreeDVNet(mcfg).to(dev)
    return TrainState(model, make_optimizer(cfg, model, steps_per_epoch,
                                            start_epoch))


def lambda_for_epoch(cfg: Config, epoch: int) -> float:
    t = cfg.train
    return 1.0 if t.finetune else min(epoch, t.lambda_ramp_epochs) * 0.1


def n_iters_for_epoch(cfg: Config, epoch: int) -> int:
    t = cfg.train
    if t.finetune or epoch >= t.iters_switch_epoch:
        return t.n_iters_late
    return t.n_iters_early


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithm picks inside the block, the caller's
    flags restored after it. cuDNN's default weight- and data-gradient picks
    for convolutions sum through atomics in a run-dependent order; the
    deterministic ones do not. The flags are process-wide, so they also
    reach the autograd engine's device thread, where the backward's
    convolutions run."""
    cd = torch.backends.cudnn
    saved = cd.deterministic, cd.benchmark
    cd.deterministic, cd.benchmark = True, False
    try:
        yield
    finally:
        cd.deterministic, cd.benchmark = saved


@contextlib.contextmanager
def _recompute(cudnn_flags):
    """The rerun of a rematerialised forward: the first run's cuDNN flags
    (the backward's are the deterministic ones), so that it takes the same
    algorithms and gives the same bits, and the BatchNorms' running
    statistics left where the first run moved them."""
    cd = torch.backends.cudnn
    saved = cd.deterministic, cd.benchmark
    cd.deterministic, cd.benchmark = cudnn_flags
    try:
        with recompute_mode():
            yield
    finally:
        cd.deterministic, cd.benchmark = saved


def remat_forward(fn: Callable[[], Any]):
    """fn() under one non-reentrant checkpoint, as `jax.checkpoint` wraps
    the JAX step's whole forward: only its inputs are kept, and the
    backward reruns it whole (early stopping off) before it needs an
    activation. The rerun launches the forward's kernels a second time,
    and counts them."""
    cd = torch.backends.cudnn
    flags = (cd.deterministic, cd.benchmark)

    def contexts():
        return contextlib.nullcontext(), _recompute(flags)

    with torch_checkpoint.set_checkpoint_early_stop(False):
        return torch_checkpoint.checkpoint(
            fn, use_reentrant=False, context_fn=contexts,
            preserve_rng_state=False)


def make_train_step(model: ThreeDVNet, cfg: Config, n_iters: int):
    """A train step for a fixed n_iters: step(state, batch, lam) runs the
    forward in train mode (the backbone's BatchNorm in eval mode unless
    finetuning), the backward and one optimizer update (or, accumulating,
    one microstep), and returns (state, {"loss", "loss_2d"}) with the
    losses as device scalars. The three phases are profiler spans:
    train_forward, train_backward, train_optimizer. The backward runs under
    `deterministic_cudnn` and the port's backward kernels sum in fixed
    point, so a step repeats bit for bit on the card; the forward (as
    inference) keeps cuDNN's default picks, and already repeats. With
    `cfg.train.remat` the forward goes through `remat_forward`: the same
    bits, its activations recomputed in the backward."""
    offsets = list(cfg.train.offsets)
    bb_train = bool(cfg.train.finetune)
    remat = bool(cfg.train.remat)
    span = torch.profiler.record_function

    def step(state: TrainState, batch, lam):
        model.train()
        state.optimizer.zero_grad()

        def forward():
            return model(batch, offsets, n_iters, lam, with_metrics=False,
                         backbone_train=bb_train)

        with span("train_forward"):
            out = remat_forward(forward) if remat else forward()
        with span("train_backward"), deterministic_cudnn():
            out["loss"].backward()
        with span("train_optimizer"):
            state.optimizer.step()
        return state, {"loss": out["loss"].detach(),
                       "loss_2d": out["loss_2d"].detach()}

    return step


def make_eval_step(model: ThreeDVNet, cfg: Config, n_iters: int = 2):
    """An eval step: the loss and the initial and final depth metrics of
    one batch in eval mode, without gradients."""
    offsets = list(cfg.train.offsets)

    def step(state: TrainState, batch):
        model.eval()
        with torch.no_grad():
            out = model(batch, offsets, n_iters, 1.0)
        mets = {("initial/" + k): v for k, v in out["initial"].items()}
        mets.update({("final/" + k): v for k, v in out["final"].items()})
        mets["loss"] = out["loss"]
        return mets

    return step


class MetricsLogger:
    """JSONL metrics log, plus tensorboard scalars where the package is
    installed."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "train"):
        rec = {"step": step, "ts": time.time()}
        for k, v in metrics.items():
            v = float(v)
            rec[f"{prefix}/{k}"] = v
            if self.tb is not None:
                self.tb.add_scalar(f"{prefix}/{k}", v, step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def _warm_start(cfg: Config, state: TrainState, variables: dict,
                epoch: int, steps_per_epoch: int) -> TrainState:
    """Load flax-style variables into the model and give it a fresh
    optimizer whose schedule is offset to `epoch`."""
    load_flax_into(state.model, variables)
    return TrainState(state.model, make_optimizer(
        cfg, state.model, steps_per_epoch, start_epoch=epoch))


def fit(cfg: Config, train_batches, val_batches: Callable[[], Iterable],
        n_epochs: int, log_dir: str = "runs/tdvnet_torch",
        ckpt_dir: Optional[str] = None, resume: bool = False,
        init_from: Optional[str] = None, export_npz: Optional[str] = None,
        export_every: int = 4, device=None):
    """The epoch loop, on `device` (the card unless named).

    train_batches: a `StreamingLoader` (has `.epoch(e)` and `__len__`) or a
    plain list of collated batches, replayed every epoch.
    resume: continue from the latest checkpoint in `ckpt_dir`; a
    checkpoint whose optimizer does not fit this regime (a train-regime
    checkpoint resumed into the finetune regime) gives its weights only,
    with a fresh optimizer offset to its epoch.
    init_from: a warm start (an exported `.npz` or a checkpoint directory)
    when `ckpt_dir` holds nothing to resume.
    export_npz: also write the weights as an `.npz` (the JAX package's
    layout) every `export_every` epochs, replaced atomically.
    Returns (model, state)."""
    from tdvnet_torch.train import checkpoints as ckpt_lib

    if hasattr(train_batches, "epoch"):
        loader = train_batches
        steps_per_epoch = max(len(loader), 1)
        epoch_iter = loader.epoch
    else:
        batches = list(train_batches)
        steps_per_epoch = max(len(batches), 1)
        epoch_iter = lambda e: iter(batches)          # noqa: E731
    state = create_state(cfg, steps_per_epoch, device)
    start_epoch = 0
    if resume and ckpt_dir is not None:
        try:
            restored = ckpt_lib.restore(ckpt_dir, state)
        except ValueError:
            restored = None
            pr = ckpt_lib.restore_params(ckpt_dir)
            if pr is not None:
                variables, start_epoch = pr
                state = _warm_start(cfg, state, variables, start_epoch,
                                    steps_per_epoch)
                print(f"[fit] weights-only warm start from epoch "
                      f"{start_epoch} (fresh optimizer, lr schedule offset "
                      f"to that epoch)", flush=True)
        if restored is not None:
            state, start_epoch = restored
    if start_epoch == 0 and init_from is not None:
        pr = ckpt_lib.restore_params(init_from)
        if pr is None:
            raise FileNotFoundError(f"init_from {init_from}: nothing to "
                                    f"restore")
        variables, start_epoch = pr
        state = _warm_start(cfg, state, variables, start_epoch,
                            steps_per_epoch)
        print(f"[fit] warm start from {init_from} (epoch {start_epoch}, "
              f"fresh optimizer, lr schedule offset to that epoch)",
              flush=True)
    if start_epoch >= n_epochs:
        raise ValueError(f"start_epoch {start_epoch} >= n_epochs {n_epochs}:"
                         f" nothing to train; raise n_epochs past the warm "
                         f"start's epoch")

    model = state.model
    logger = MetricsLogger(log_dir, cfg.train.use_tensorboard)
    step_fns = {}
    eval_step = make_eval_step(model, cfg)
    gstep = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, n_epochs):
        n_it = n_iters_for_epoch(cfg, epoch)
        if n_it not in step_fns:
            step_fns[n_it] = make_train_step(model, cfg, n_it)
        lam = lambda_for_epoch(cfg, epoch)
        for batch in epoch_iter(epoch):
            state, mets = step_fns[n_it](state, batch, lam)
            if gstep % cfg.train.log_every == 0:
                logger.log(gstep, mets, "train")
            gstep += 1
        if ckpt_dir is not None and \
                (epoch + 1) % cfg.train.ckpt_every_epochs == 0:
            ckpt_lib.save(ckpt_dir, state, epoch + 1, cfg)
        if export_npz is not None and (epoch + 1) % export_every == 0:
            tmp = export_npz + ".tmp.npz"
            ckpt_lib.export_npz(tmp, to_flax_variables(model),
                                epoch=epoch + 1)
            os.replace(tmp, export_npz)
        # a failed validation must not end a long run: the checkpoint
        # above is on disk
        try:
            vals = [eval_step(state, b) for b in val_batches()]
            if vals:
                agg = {k: float(np.mean([float(v[k]) for v in vals]))
                       for k in vals[0]}
                logger.log(gstep, agg, "val")
        except Exception as e:                        # noqa: BLE001
            print(f"[fit] validation failed at epoch {epoch}: {e!r}; "
                  f"continuing training", flush=True)
    logger.close()
    return model, state
