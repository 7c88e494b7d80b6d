"""Checkpoints with auto-resume (counterpart of scldm_tpu/training/checkpoint.py,
which writes orbax checkpoints; orbax would import jax, so the port has a
format of its own).

Each step is a directory `<directory>/<step>/` holding one `torch.save` file,
`state.pt`, with

- `module`: the module's state dict, under the reference's parameter names
  (the names `utils.weights.load_reference_state_dict` reads);
- `optimizer`: the optimizer's state dict (its step count included);
- `step`: the number of optimizer steps taken;
- `generator`: the state of the train state's random generator, so a
  resumed run draws what an uninterrupted one would;
- `ema`: the averaged parameters and the EMA's update count, or None;
- `metrics`: the metrics the step was saved with.

The file is written under a temporary name and renamed, so a killed write
never leaves a checkpoint that looks whole; a step directory without
`state.pt` is not a checkpoint. A JSON config snapshot (`config.json`) sits
beside the steps. Checkpoints load with `torch.load(weights_only=True)`:
tensors, numbers and strings only.

Under a process group the payload is the one-process format: rank 0 writes
full tensors, the module and the optimizer state gathered out of FSDP
slices, and `generators` holds every rank's generator state; the other ranks
take part in the gathers and wait at a barrier. Megatron slices (the
module's, their AdamW moments and EMA) are gathered whole the same way. So a
run saved at one world size resumes at another: a load slices the full
tensors for Megatron and FSDP, a rank without a saved generator state
draws a seed from rank 0's, and the ranks that share rows (a data row's
model ranks) then take their first one's. Where the
ranks span machines, a directory under /tmp, /var or /dev/shm is refused
(JAX's guard): every rank must read what rank 0 wrote.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from scldm_torch.parallel.distributed import (
    barrier,
    rank,
    spans_nodes,
    sync_generator_,
    world_size,
)
from scldm_torch.parallel.tensor_parallel import megatron_of

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _to_host(obj):
    """A copy of `obj` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot(state, metrics: Optional[dict] = None) -> Optional[Dict[str, Any]]:
    """The checkpoint payload of a `training.state.TrainState`, in host
    memory. Under a process group every rank must call it (Megatron and FSDP
    slices and the generators are gathered); rank 0 gets the payload, the
    others None."""
    world, first = world_size(), rank() == 0
    generators = None
    if world > 1:
        generators = [None] * world
        dist.all_gather_object(generators, state.generator.get_state())
    mt = megatron_of(state.module)
    trained = [p for p in state.module.parameters() if p.requires_grad]
    if state.shards is not None:
        with state.shards.gathered():
            module = _module_state(state.module, mt, first)
        optimizer = state.shards.full_optimizer_state(state.optimizer)
    else:
        module = _module_state(state.module, mt, first)
        optimizer = state.optimizer.state_dict()
    ema = None if state.ema is None else state.ema.params
    if mt is not None:
        optimizer = mt.whole_optimizer_state(optimizer, trained)
        if ema is not None:
            ema = mt.whole_named(state.module, ema)
    if not first:
        return None
    payload = {
        "module": module,
        "optimizer": _to_host(optimizer),
        "step": int(state.step),
        "generator": state.generator.get_state().clone(),
        "ema": None if state.ema is None else {
            "params": _to_host(ema), "step": int(state.ema.step)},
        "metrics": dict(metrics or {}),
    }
    if generators is not None:
        payload["generators"] = [g.clone() for g in generators]
    return payload


def _module_state(module, mt, first: bool):
    """The module's state dict on the host for rank 0 (None elsewhere), its
    Megatron slices gathered whole (every rank takes part)."""
    if mt is None:
        return _to_host(module.state_dict()) if first else None
    sd = mt.whole_state_dict(module.state_dict())
    return _to_host(sd) if first else None


def _set_generator(generator: torch.Generator, payload: Dict[str, Any]) -> None:
    """This rank's saved generator state, or for a rank the saved run did not
    have, a seed drawn from rank 0's plus the rank."""
    r = rank()
    saved = payload.get("generators") or [payload["generator"]]
    if r < len(saved):
        generator.set_state(saved[r])
        return
    generator.set_state(payload["generator"])
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    generator.manual_seed(seed + r)


@torch.no_grad()
def load_into(template, payload: Dict[str, Any]):
    """Copy a payload into the train state `template`, in place, on the
    template's device; returns it. Under FSDP each rank keeps its slices of
    the full tensors."""
    shards, mt = template.shards, megatron_of(template.module)
    module, optimizer = payload["module"], payload["optimizer"]
    if mt is not None:
        trained = [p for p in template.module.parameters() if p.requires_grad]
        module = mt.sliced_state_dict(module)
        optimizer = mt.sliced_optimizer_state(optimizer, trained)
    if shards is None:
        template.module.load_state_dict(module)
        template.optimizer.load_state_dict(optimizer)
    else:
        with shards.gathered():
            template.module.load_state_dict(module)
            shards.load_slices()
        template.optimizer.load_state_dict(
            shards.sliced_optimizer_state(optimizer, template.optimizer))
    template.step = int(payload["step"])
    _set_generator(template.generator, payload)
    if template.sync_group is not None:
        sync_generator_(template.generator, template.sync_group)
    if (payload["ema"] is None) != (template.ema is None):
        raise ValueError("the checkpoint and the template disagree on having an EMA")
    if template.ema is not None:
        params = payload["ema"]["params"]
        if mt is not None:
            params = mt.sliced_named(template.module, params)
        if set(params) != set(template.ema.params):
            raise KeyError("the checkpoint's EMA parameters are not the template's")
        for name, t in template.ema.params.items():
            t.copy_(params[name])
        template.ema.step = int(payload["ema"]["step"])
    return template


def read_payload(step_dir: str | Path) -> Dict[str, Any]:
    """The payload of one step directory, on the host."""
    return torch.load(Path(step_dir) / STATE_FILE, map_location="cpu", weights_only=True)


class _StepDirs:
    """The step directories under one directory, with a retention rule:
    the newest `max_to_keep`, or with `monitor` the `max_to_keep` best by
    that metric (`mode` min or max, the older step first on ties)."""

    def __init__(self, directory: Path, max_to_keep: Optional[int],
                 monitor: Optional[str] = None, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min or max, not {mode!r}")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        directory.mkdir(parents=True, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def metrics(self, step: int) -> dict:
        p = self.directory / str(step) / METRICS_FILE
        return json.loads(p.read_text()) if p.exists() else {}

    def ranked(self) -> List[int]:
        """Steps best first by the monitored metric."""
        sign = 1.0 if self.mode == "min" else -1.0
        return sorted(self.steps(), key=lambda s: (sign * self.metrics(s)[self.monitor], s))

    def write(self, step: int, payload: Dict[str, Any]) -> None:
        d = self.directory / str(step)
        d.mkdir(parents=True, exist_ok=True)
        (d / METRICS_FILE).write_text(json.dumps(payload["metrics"]))
        tmp = d / f"{STATE_FILE}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, d / STATE_FILE)
        self._retain()

    def _retain(self) -> None:
        if not self.max_to_keep:
            return
        keep = self.ranked() if self.monitor else self.steps()[::-1]
        for step in keep[self.max_to_keep:]:
            shutil.rmtree(self.directory / str(step), ignore_errors=True)


class CheckpointManager:
    """Save-last retention for resume, plus optional best-k retention by a
    monitored metric in `best/` (Lightning's ModelCheckpoint(save_last=True,
    save_top_k=k, monitor="val_loss"), the reference's training/default.yaml:
    42-52). Auto-resume sees the true latest step while `best/` keeps the k
    best validation snapshots. A step at or before the latest saved one is
    not saved again (orbax's rule).

    `async_save=True` copies the state to host memory in the caller, then
    writes on one background thread, so the write overlaps training;
    `close()` and every reader wait for the writes in flight. Under a
    process group every rank calls `save` (the snapshot gathers), rank 0
    writes, and the ranks meet at a barrier once the write is done."""

    def __init__(
        self,
        directory: str | Path,
        max_to_keep: int = 3,
        monitor: Optional[str] = None,
        save_top_k: int = 1,
        mode: str = "min",
        async_save: bool = False,
    ):
        self.directory = Path(directory).absolute()
        if spans_nodes() and str(self.directory).startswith(("/tmp/", "/var/", "/dev/shm/")):
            raise ValueError(
                f"checkpoint dir {self.directory} is host-local but this run's ranks span "
                "machines; use a filesystem every rank reads (NFS, a bucket mount)")
        self._steps = _StepDirs(self.directory, max_to_keep)
        self.monitor = monitor
        self._best = (_StepDirs(self.directory / "best", save_top_k, monitor, mode)
                      if monitor and save_top_k else None)
        self.async_save = async_save
        self._writer = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: list = []
        self._barrier_due = False

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        self._steps.write(step, payload)
        if self._best is not None and self.monitor in payload["metrics"]:
            self._best.write(step, payload)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> bool:
        """Checkpoint `state` at `step`; returns False (and writes nothing)
        if a checkpoint at `step` or later exists."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        payload = snapshot(state, metrics)
        if payload is None:
            pass  # another rank than 0: rank 0 writes
        elif self._writer is None:
            self._write(step, payload)
        else:
            self._pending.append(self._writer.submit(self._write, step, payload))
        if world_size() > 1:
            self._barrier_due = True
            if self._writer is None:
                self.wait_until_finished()
        return True

    def wait_until_finished(self) -> None:
        """Wait for the writes in flight (none with synchronous saves), and
        under a process group for rank 0's last write; re-raises a write's
        error."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        if self._barrier_due:
            self._barrier_due = False
            barrier()

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step of the best checkpoint by the monitored metric (None
        without monitored saves)."""
        if self._best is None:
            return None
        self.wait_until_finished()
        ranked = self._best.ranked()
        return ranked[0] if ranked else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Load the checkpoint at `step` (default the latest) into the train
        state `template`, on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self.wait_until_finished()
        return load_into(template, read_payload(self.directory / str(step)))

    def restore_best(self, template: Any) -> Any:
        step = self.best_step()
        if step is None:
            raise FileNotFoundError(f"no best checkpoint in {self.directory / 'best'}")
        return load_into(template, read_payload(self.directory / "best" / str(step)))

    def maybe_restore(self, template: Any) -> tuple[Any, int]:
        """Auto-resume: the latest checkpoint loaded into `template` if one
        exists (the reference's train.py:81-88), else the template as it is."""
        step = self.latest_step()
        if step is None:
            return template, 0
        return self.restore(template, step), step

    def save_config(self, config: dict, name: str = "config.json") -> None:
        """Write the config snapshot (rank 0; the others wait for it)."""
        if rank() == 0:
            (self.directory / name).write_text(json.dumps(config, indent=2, default=str))
        barrier()

    def load_config(self, name: str = "config.json") -> Optional[dict]:
        p = self.directory / name
        return json.loads(p.read_text()) if p.exists() else None

    def close(self) -> None:
        self.wait_until_finished()
        if self._writer is not None:
            self._writer.shutdown(wait=True)
