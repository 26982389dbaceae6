"""Checkpoint / resume of the federated state, in torch's own format (the
reference's ``utils/checkpoint.py`` policy without Orbax).

``FedCheckpointer`` honours ``cfg.checkpoint_dir``, ``checkpoint_every``
and ``resume``. A checkpoint is one file ``<dir>/step_<N>.pt`` holding
every ``FedState`` leaf (params, server momentum and error — dense vectors
or f32/bf16 tables —, both client banks, ``step`` and the compressor's
``comp``, powersgd's ``Q``), the model's ``grad_size`` and, for sketch
modes, the sketch-layout fingerprint. The sampler, the lr schedule and the
fedsim environment need no state: each is a pure function of ``(seed,
round)``, so restoring ``step`` restores the whole training clock, and a
resumed run reproduces the unbroken one bit for bit on the same device.

The policy is the reference's: a save every ``checkpoint_every`` rounds
(and a forced one at the end of training), never twice for a step already
on disk; at most ``MAX_TO_KEEP`` steps kept; a manifest sidecar
(``<dir>/manifests/<N>.json``, the file's size and sha256) written with
every save and verified by ``restore``, which walks back to the next
older step when the newest fails (a named step is restored strictly);
restore refuses a checkpoint of another model (``grad_size``) or of
another sketch layout. Files are written to a temporary name and renamed,
so a killed save leaves no partial step. In a worker group rank 0 of the
grid writes and every rank restores. A sharded leaf (``FederatedSession.
sharded_leaves``: true_topk's state under sparse aggregation, FSDP's
params and dense state) is saved whole, as the padded ``[padded_dim]``
vector every rank's slice is gathered into (``full_state``: every rank
takes part in a save then), and each rank restores its own slice of it
(``set_full_state``), so resume stays bit-exact and the file does not
depend on the group's layout beyond the padding.

A session of the control plane saves its controller's ``state_blob()``
(``control``, the reference's float64 layout) beside the state, in the
ACTIVE rung's layout: restore reads the saved rung from that blob, checks
the leaves and the sketch layout against THAT rung's spec, installs them,
switches the dispatch to the rung without a migration and loads the blob,
so the resumed run goes on with the unbroken run's rung sequence. A
checkpoint with a blob is refused by a session without a controller; one
without a blob restores into a controlled session with a warning (the
controller starts fresh), as the reference does.

A session with a resilience blacklist (``recover_policy='skip_clients'``)
saves it (``blacklist``, int64 client ids), and restore blacklists those
clients again, so a resume does not re-admit them. The leaves go back into
a session through ``commit_fed_state``, which the resilience vault's
rollback shares. A recovery drops the checkpoints above its rollback round
(``discard_steps_after``) and, after a policy that forks the run, saves
the rollback round again (``resave``).

A hosted client store's banks (``--client_store host|mmap``) are not
``FedState`` leaves: the file carries them as ``host_vel`` and
``host_err`` (the session's properties, read after the streamer's fence),
and restore loads them through the same properties, which invalidate
every staged and cached row. Not ported: the reference's migration of
checkpoints older than its ``comp`` leaf (the port has no older format).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from commefficient_tpu_torch.parallel.round import FedState

MAX_TO_KEEP = 3
FORMAT = 1
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
           "step", "comp")


def spec_fingerprint(spec) -> List[int]:
    """The sketch-layout identity a checkpointed [r, c] table depends on
    (the reference's fields and order): equal table shapes do not imply
    equal layouts, and decoding a table under another layout silently
    yields garbage."""
    families = {"fmix32": 1, "poly4": 2}
    return [int(x) for x in (
        spec.d, spec.c, spec.r, spec.num_blocks, spec.seed, spec.chunk_m,
        spec.sblock, spec.band, spec.d_eff, spec.c_actual,
        families.get(spec.hash_family, 0))]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_host(leaf):
    return leaf.detach().to("cpu") if torch.is_tensor(leaf) else leaf


def commit_fed_state(session, leaves: dict) -> None:
    """Install ``leaves`` (every ``FedState`` leaf in ``full_state``'s
    layout: host or device tensors, None, the int ``step``) into
    ``session``: each tensor copied onto the session's device, a sharded
    leaf cut to this rank's slice (``set_full_state``). The checkpoint
    restore and the resilience vault's rollback both commit through here,
    so the two cannot drift; the copy keeps the caller's tensors apart
    from the state the rounds update in place."""
    session.set_full_state(FedState(**{
        f: (v.to(session.device, copy=True) if torch.is_tensor(v) else v)
        for f, v in leaves.items()}))


class FedCheckpointer:
    """Saves and restores a ``FederatedSession``'s state under
    ``cfg.checkpoint_dir`` (disabled without one)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.root = (os.path.abspath(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        self.last_save_ms = self.last_restore_ms = None
        self.last_bytes = None

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step)}.pt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.root, "manifests", f"{int(step)}.json")

    def all_steps(self) -> List[int]:
        if not self.enabled or not os.path.isdir(self.root):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                    os.listdir(self.root))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def will_save(self, round_idx: int, *, force: bool = False) -> bool:
        """True iff ``maybe_save(round_idx)`` would write a checkpoint."""
        if not self.enabled:
            return False
        every = self.cfg.checkpoint_every
        return force or (every > 0 and round_idx > 0
                         and round_idx % every == 0)

    def maybe_save(self, session, round_idx: int, *,
                   force: bool = False) -> bool:
        """Save if ``checkpoint_every`` divides ``round_idx`` (or forced),
        unless the step is already on disk (the end-of-training forced save
        may land on a boundary the loop already wrote). Rank 0 writes, and
        only it returns True."""
        if not self.will_save(round_idx, force=force):
            return False
        t0 = time.perf_counter()
        # every rank gathers the sharded leaves (a collective) before rank
        # 0 decides whether to write
        st = session.full_state() if session.sharded_leaves else \
            session.state
        if not session.is_lead or round_idx in self.all_steps():
            return False
        blob = {"format": FORMAT, "grad_size": int(session.grad_size),
                "fed_state": {f: _to_host(getattr(st, f)) for f in _LEAVES}}
        if session.spec is not None:
            blob["sketch_layout"] = spec_fingerprint(session.spec)
        if session.controller is not None:
            # drains happen before saves, so the blob reflects every
            # drained round up to this step
            blob["control"] = torch.from_numpy(
                session.controller.state_blob())
        if session._client_blacklist is not None:
            # the skip_clients blacklist only grows: a resumed run keeps
            # masking the clients a recovery condemned
            blob["blacklist"] = torch.from_numpy(
                session._client_blacklist.astype("int64"))
        for name in ("host_vel", "host_err"):
            bank = getattr(session, name)  # after the streamer's fence
            if bank is not None:
                blob[name] = torch.from_numpy(np.asarray(bank))
        os.makedirs(os.path.join(self.root, "manifests"), exist_ok=True)
        path = self.path(round_idx)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        self._write_manifest(round_idx)
        self._rotate()
        self.last_save_ms = 1e3 * (time.perf_counter() - t0)
        self.last_bytes = os.path.getsize(path)
        return True

    def _write_manifest(self, step: int) -> None:
        path = self.path(step)
        manifest = {"step": int(step), "file": os.path.basename(path),
                    "size": os.path.getsize(path),
                    "sha256": _sha256_file(path)}
        mpath = self._manifest_path(step)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, mpath)

    def _rotate(self) -> None:
        for step in self.all_steps()[:-MAX_TO_KEEP]:
            self._delete(step)

    def _delete(self, step: int) -> None:
        for p in (self.path(step), self._manifest_path(step)):
            try:
                os.remove(p)
            except FileNotFoundError:  # absent, or another rank's delete
                pass

    def discard_steps_after(self, step: int) -> None:
        """Delete the retained checkpoints above round ``step`` and their
        manifests (rank 0): after a rollback to ``step`` they hold the
        rolled-back trajectory. A ``retry`` replay would write them again
        bit for bit, but a forking recovery would not, and ``maybe_save``
        never overwrites a step on disk, so a later ``--resume`` would
        restore a state from before the recovery."""
        if not self.enabled:
            return
        for s in self.all_steps():
            if s > int(step):
                self._delete(s)

    def resave(self, session, step: int) -> bool:
        """Save the session's CURRENT state at ``step``, replacing a
        retained checkpoint there: after a forking recovery the rollback
        round's state is restored but the policy changed what the old file
        predates (the demotion floor, the blacklist), and a crash before
        the next boundary must resume with the fork. No-op without a
        checkpoint_dir."""
        if not self.enabled:
            return False
        self._delete(step)
        return self.maybe_save(session, int(step), force=True)

    def verify_step(self, step: int) -> Optional[str]:
        """None when the step's file matches its manifest, else the
        reason it does not (a step without a manifest is rejected: every
        save writes one)."""
        path, mpath = self.path(step), self._manifest_path(step)
        if not os.path.exists(path):
            return f"missing file {os.path.basename(path)!r}"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return f"unreadable manifest ({type(e).__name__}: {e})"
        size = os.path.getsize(path)
        if size != manifest["size"]:
            return (f"size mismatch ({size} B on disk, manifest says "
                    f"{manifest['size']} B)")
        if _sha256_file(path) != manifest["sha256"]:
            return "sha256 mismatch"
        return None

    def restore(self, session, step: Optional[int] = None) -> Optional[int]:
        """Restore into ``session`` in place; returns the restored round
        (``FedState.step``) or None when there is nothing to restore. With
        ``step=None`` the newest retained step is tried first and each
        failure (manifest or load) falls back to the next older one with a
        warning naming the step and the reason; a named ``step`` is
        restored strictly."""
        if not self.enabled:
            return None
        if step is not None:
            bad = self.verify_step(step)
            if bad is not None:
                raise ValueError(f"checkpoint at step {step} failed "
                                 f"integrity verification: {bad}")
            return self._restore_step(session, step)
        steps = self.all_steps()[::-1]
        failures = []
        for n, s in enumerate(steps):
            reason = self.verify_step(s)
            if reason is None:
                try:
                    return self._restore_step(session, s)
                except ValueError as e:
                    if "grad_size" in str(e) or "sketch layout" in str(e):
                        raise  # the wrong model or layout, not a bad file
                    reason = f"{type(e).__name__}: {e}"
            failures.append((s, reason))
            older = len(steps) - n - 1
            warnings.warn(
                f"checkpoint at step {s} REJECTED ({reason})"
                + (f"; falling back to the next of {older} older step(s)"
                   if older else "; no older steps left"), stacklevel=2)
        if not failures:
            return None
        raise ValueError(
            "restore failed at every retained checkpoint step — "
            + "; ".join(f"step {s}: {r}" for s, r in failures))

    def _restore_step(self, session, step: int) -> int:
        t0 = time.perf_counter()
        try:
            blob = torch.load(self.path(step), map_location="cpu",
                              weights_only=True)
        except Exception as e:  # noqa: BLE001 - any unreadable file
            raise ValueError(f"unreadable checkpoint ({type(e).__name__}: "
                             f"{e})") from e
        controller = session.controller
        if "control" in blob and controller is None:
            raise ValueError(
                "checkpoint carries adaptive-control state ('control' "
                "blob) but this session was built without a controller — "
                "restore with the same control_policy/ladder the run was "
                "saved under")
        # the template is the SAVED rung's layout: its spec and leaves
        spec, rung, template = session.spec, None, {}
        if "control" in blob:
            rung = int(blob["control"][1])
            if not 0 <= rung < len(session.rungs):
                raise ValueError(
                    f"controller checkpoint names rung {rung}, but this "
                    f"session's ladder has {len(session.rungs)} rung(s) — "
                    "restore with the ladder the checkpoint was written "
                    "under")
            spec = session.rungs[rung].spec
            template = session.rung_state_template(rung)
        if spec is not None and "sketch_layout" in blob:
            want = spec_fingerprint(spec)
            got = [int(x) for x in blob["sketch_layout"]]
            if want != got:
                raise ValueError(
                    "checkpoint sketch layout != this session's: the [r, c] "
                    "tables were written under another CountSketch layout "
                    f"(stamp {got} vs {want}; fields: d, c, r, num_blocks, "
                    "seed, chunk_m, sblock, band, d_eff, c_actual, "
                    "hash_family) — decoding them here would corrupt "
                    "training silently. Match the spec or re-train.")
        if blob["grad_size"] != session.grad_size:
            raise ValueError(
                f"checkpoint grad_size {blob['grad_size']} != model "
                f"{session.grad_size} — wrong model/config for this "
                "checkpoint")
        fs = blob["fed_state"]
        leaves = {}
        for f in _LEAVES:
            saved = fs[f]
            if f in template:  # (full shape, dtype) at the saved rung
                have = template[f]
            else:
                have = getattr(session.state, f)
                if torch.is_tensor(have):
                    have = (session.full_shape(f), have.dtype)
            if (have is None) != (saved is None):
                raise ValueError(
                    f"checkpoint leaf {f!r} is "
                    f"{'absent' if saved is None else 'present'} but this "
                    "session's is not: restore with the mode and settings "
                    "the run was saved under")
            if torch.is_tensor(saved):
                shape, dtype = have
                if tuple(saved.shape) != shape or saved.dtype != dtype:
                    raise ValueError(
                        f"checkpoint leaf {f!r} is {tuple(saved.shape)} "
                        f"{saved.dtype}, this session's {shape} {dtype}")
            leaves[f] = saved
        if rung is not None:
            # the dispatch on the saved rung: the leaves are in its
            # layout, so nothing migrates
            session.set_active_rung(rung, migrate=False)
        commit_fed_state(session, leaves)
        for name in ("host_vel", "host_err"):
            if name in blob:  # loads the bank, stales every staged row
                setattr(session, name, blob[name].numpy())
        if controller is not None:
            if "control" in blob:
                # the saved rung again (a no-op) and the policy's state:
                # the resumed rung sequence is the unbroken run's
                controller.load_state_blob(blob["control"].numpy())
            else:
                warnings.warn(
                    f"checkpoint at step {step} predates the adaptive-"
                    "communication controller; restored everything else — "
                    "the controller starts fresh (initial rung, zero byte "
                    "spend), so the resumed rung sequence is NOT the "
                    "uninterrupted run's", stacklevel=3)
        if "blacklist" in blob and blob["blacklist"].numel():
            # condemned again: blacklist_clients refuses a session that
            # cannot mask them (no fedsim) rather than re-admit them
            session.blacklist_clients(blob["blacklist"].numpy())
        session.sync_round_clock()
        self.last_restore_ms = 1e3 * (time.perf_counter() - t0)
        return int(leaves["step"])
