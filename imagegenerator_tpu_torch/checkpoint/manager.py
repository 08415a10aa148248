"""Checkpoint and resume with the layout contract of the JAX package's
``imagegenerator_tpu/checkpoint/manager.py``, in the port's own format.

A state is the flat ``<field>/<flax path>`` dict of numpy arrays that
``imagegenerator_tpu_torch.convert`` reads and writes (parameters,
BatchNorm statistics, optimizer state, step), saved as one ``.npz`` — the
format ``params.npz`` has. The JAX package can rebuild its
``Stage1State`` / ``Stage2State`` from that dict, and the other way
round. No Orbax. A local directory only: ``gs://`` is not ported.

Layout under ``directory``::

    epochs/checkpoint_epoch_<N>/state.npz   one per saved epoch, never rewritten
    latest/state.npz                        a rolling copy of the newest
    LATEST_EPOCH                            the newest complete epoch, as text

* ``save(epoch, flat)`` writes both copies, each to a temporary name that
  ``os.replace`` publishes, and only then the marker: a crash can never
  leave the marker pointing at a torn checkpoint.
* ``restore_latest()`` reads the per-epoch file the marker names and
  returns ``(flat, saved_epoch + 1)``, or ``(None, 0)`` with no marker. A
  checkpoint that the marker names and that cannot be read raises.
* under data parallelism (``parallel/dp.py``) rank 0 alone writes and
  every rank then waits at a barrier, so no rank reads or resumes past a
  checkpoint that is not on disk yet; the other ranks' ``flat`` is not
  read. Every rank restores. Under tensor parallelism the trainer hands
  rank 0 the whole state, gathered from the model groups
  (``convert.to_numpy``), and every rank cuts its slices from the
  restored dict (``Stage1System.shard``): a checkpoint of a ``--tp``
  run is the one-process dict, which loads anywhere.
* ``save_with_aux(epoch, flat, aux)`` stores ``{"state": flat, "aux":
  aux}``: the keys get the prefixes ``state/`` and ``aux/`` (the
  trainer's EMA tree lies under ``aux/ema/``). ``restore_latest`` on such
  a checkpoint gives the live state; ``restore_latest_with_aux`` on a
  plain one gives ``aux=None``.
"""

from __future__ import annotations

import os

import numpy as np

from imagegenerator_tpu_torch.parallel import dp

_FILE = "state.npz"
_PREFIXES = ("state/", "aux/")


class CheckpointManager:
    def __init__(self, directory: str, save_every_epochs: int = 10):
        if "://" in directory:
            raise NotImplementedError(f"{directory}: only local checkpoint directories are ported")
        self.directory = directory
        self.save_every_epochs = save_every_epochs

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, "epochs", f"checkpoint_epoch_{epoch}")

    def _latest_dir(self) -> str:
        return os.path.join(self.directory, "latest")

    def _marker(self) -> str:
        return os.path.join(self.directory, "LATEST_EPOCH")

    def should_save(self, epoch: int) -> bool:
        return epoch % self.save_every_epochs == 0

    @staticmethod
    def _publish(path: str, write) -> None:
        """``write(file)`` into a temporary name beside ``path``, then an
        atomic rename."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def save(self, epoch: int, flat: dict) -> None:
        """Dual write (per-epoch file, rolling latest), then the marker;
        on rank 0 only, then a barrier of all ranks."""
        if dp.is_main():
            for directory in (self._epoch_dir(epoch), self._latest_dir()):
                self._publish(os.path.join(directory, _FILE), lambda f: np.savez(f, **flat))
            self._publish(self._marker(), lambda f: f.write(str(epoch).encode()))
        dp.barrier()

    def save_with_aux(self, epoch: int, flat: dict, aux: dict) -> None:
        """``save`` with a side dict (the trainer's ``{"ema/<key>": ...}``)."""
        payload = {f"state/{k}": v for k, v in flat.items()}
        payload.update({f"aux/{k}": v for k, v in aux.items()})
        self.save(epoch, payload)

    def latest_epoch(self) -> int:
        """The marker's epoch, or -1 where there is no marker."""
        try:
            with open(self._marker()) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return -1

    def restore_latest_with_aux(self):
        """``(flat, aux, start_epoch)`` from either layout: a checkpoint of
        ``save_with_aux`` gives both, a plain one ``aux=None`` (the caller
        then starts its side state from the restored one)."""
        epoch = self.latest_epoch()
        if epoch < 0:
            return None, None, 0
        with np.load(os.path.join(self._epoch_dir(epoch), _FILE)) as f:
            payload = {k: f[k] for k in f.files}
        if not all(k.startswith(_PREFIXES) for k in payload):
            return payload, None, epoch + 1
        flat = {k[len("state/"):]: v for k, v in payload.items() if k.startswith("state/")}
        aux = {k[len("aux/"):]: v for k, v in payload.items() if k.startswith("aux/")}
        return flat, aux, epoch + 1

    def restore_latest(self):
        """``(flat, start_epoch)``; ``start_epoch`` is the saved epoch + 1.
        Reads the per-epoch file the marker names, not ``latest``: the
        next save rewrites ``latest`` while the marker still names the
        epoch before."""
        flat, _, start_epoch = self.restore_latest_with_aux()
        return flat, start_epoch
