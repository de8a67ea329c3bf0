"""Step-numbered checkpoint directories with atomic publish.

Counterpart of ``incubator_mxnet_tpu/utils/checkpoint.py``, with the same
on-disk layout: ``{prefix}-{step:08d}/`` holding ``params`` (the npz
container of ``ndarray.save``), an optional ``trainer`` payload and
``meta.json``, written to a temporary directory, fsynced and renamed into
place. ``meta.json`` is written last, so its presence marks a complete
checkpoint. Pointers (small JSON documents such as the serving generation
pointer) publish the same way.

Saves are synchronous (``async_save=False``), as the serving plane uses
them. ``install_preemption_handler`` runs one final save on SIGTERM, as the
JAX package's does (``resilience.GuardedTrainer`` installs it).
"""

import json
import os
import shutil
import signal
import time
import warnings
import zipfile

from ..ndarray import ndarray as nd

__all__ = ["CheckpointManager"]

_TMP_SUFFIX = ".tmp"


class CheckpointManager:
    """Manage a directory of step-numbered checkpoints.

    keep : newest complete checkpoints to retain (older ones are pruned
        after each durable save); None keeps everything.
    """

    def __init__(self, directory, keep=3, async_save=False, prefix="ckpt"):
        if keep is not None and keep < 1:
            raise ValueError("keep must be >= 1 (or None for unlimited); "
                             "keep=%r would prune every checkpoint" % keep)
        if async_save:
            raise NotImplementedError(
                "background checkpoint writes are not part of the port yet; "
                "use async_save=False")
        self._dir = directory
        self._keep = keep
        self._prefix = prefix
        os.makedirs(directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self._dir, "%s-%08d" % (self._prefix, int(step)))

    def steps(self):
        """Sorted steps with COMPLETE checkpoints on disk."""
        out = []
        pat = self._prefix + "-"
        for e in os.listdir(self._dir):
            if not e.startswith(pat) or e.endswith(_TMP_SUFFIX):
                continue
            if not os.path.exists(os.path.join(self._dir, e, "meta.json")):
                continue
            try:
                out.append(int(e[len(pat):]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    # ---------------------------------------------------------------- save
    def save(self, step, params, trainer=None, extra=None):
        """Checkpoint ``params`` (dict name -> tensor or array) at ``step``.
        ``trainer`` is a raw bytes payload stored alongside; ``extra`` is
        merged into meta.json."""
        if trainer is not None and not isinstance(trainer, (bytes, bytearray)):
            raise TypeError("trainer must be a bytes payload")
        meta = {"step": int(step), "time": time.time(),
                "param_names": sorted(params)}
        if extra:
            meta.update(extra)
        final = self._path(step)
        tmp = "%s%s.%d" % (final, _TMP_SUFFIX, os.getpid())
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        nd.save(os.path.join(tmp, "params"), dict(params))
        if trainer is not None:
            with open(os.path.join(tmp, "trainer"), "wb") as f:
                f.write(bytes(trainer))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        # an existing step is renamed aside first, so the step always has a
        # complete checkpoint on disk; the aside name parses as no step
        old = None
        if os.path.exists(final):
            old = "%s.old%s.%d" % (final, _TMP_SUFFIX, os.getpid())
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(final, old)
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        self._prune()

    def _prune(self):
        if self._keep is None:
            return
        for s in self.steps()[:-self._keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------ pointers
    def publish_pointer(self, name, value):
        """Atomically publish a small JSON document ``name`` in the
        directory: write to a temporary file, fsync, rename."""
        final = os.path.join(self._dir, name)
        tmp = "%s%s.%d" % (final, _TMP_SUFFIX, os.getpid())
        with open(tmp, "w") as f:
            json.dump(value, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final

    def read_pointer(self, name):
        """The document ``publish_pointer`` wrote; None when absent or
        unreadable."""
        try:
            with open(os.path.join(self._dir, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ------------------------------------------------------------- restore
    def _load(self, step):
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        params = nd.load(os.path.join(path, "params"))
        trainer_payload = None
        tpath = os.path.join(path, "trainer")
        if os.path.exists(tpath):
            with open(tpath, "rb") as f:
                trainer_payload = f.read()
        return int(step), params, trainer_payload, meta

    def restore(self, step=None):
        """(step, params, trainer bytes or None, meta) of checkpoint
        ``step`` (default: the newest readable one; an unreadable newest
        one is skipped with a warning). params are CPU tensors."""
        if step is not None:
            return self._load(step)
        avail = self.steps()
        if not avail:
            raise FileNotFoundError("no complete checkpoint under %s"
                                    % self._dir)
        errors = []
        for s in reversed(avail):
            try:
                return self._load(s)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                errors.append(e)
                warnings.warn(
                    "CheckpointManager(%s): checkpoint step %d is unreadable "
                    "(%s: %s); falling back to the previous retained step"
                    % (self._dir, s, type(e).__name__, e))
        raise errors[0]

    def install_preemption_handler(self, get_state, signals=(signal.SIGTERM,)):
        """On SIGTERM (preemption notice), run ONE final synchronous save
        and chain to the previous handler.

        get_state : callable() -> (step, params_dict[, trainer[, extra]])
            invoked inside the handler.
        Returns the uninstall callable."""
        prev = {}

        def handler(signum, frame):
            try:
                state = get_state()
                step, params = state[0], state[1]
                trainer = state[2] if len(state) > 2 else None
                extra = dict(state[3]) if len(state) > 3 else {}
                extra["preempted"] = True
                self.save(step, params, trainer=trainer, extra=extra)
            finally:
                old = prev.get(signum)
                if callable(old):
                    old(signum, frame)
                elif old == signal.SIG_DFL:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

        for s in signals:
            prev[s] = signal.signal(s, handler)

        def uninstall():
            for s, old in prev.items():
                signal.signal(s, old if old is not None else signal.SIG_DFL)
        return uninstall
