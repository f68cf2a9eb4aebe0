"""Retry a training loop from its last checkpoint. Port of
fast3dhpe_tpu/train/resilience.py `run_with_retries`.

Both loops write a rolling `latest` (weights, optimizer state, step, best
metric) and take `resume=True`; this wrapper re-enters a loop after a
retryable failure, losing at most `checkpoint_every - 1` epochs. Apps opt
in with `--retries N`.

Which failures are retryable. A CUDA error that CUDA calls sticky (an
illegal or misaligned address, an unspecified launch failure, a
device-side assert, an uncorrectable ECC error) poisons the process's
CUDA context: every later call in the process fails, so an in-process
retry cannot succeed, and only a new process (`--resume`) recovers. Out
of memory and every numerical or programming error come from the work
itself and would fail the same way again, and so does a step that
cannot be captured into a CUDA graph (cuda_graphs.py
GraphCaptureError). What passes is what leaves the context usable and
comes from outside the work: the card held by another process ("busy or
unavailable"), and host I/O errors while reading the data or writing a
checkpoint (EIO, ESTALE, ETIMEDOUT, as from a network filesystem).

The degrade ladder is the JAX package's (resilience.py:181-194): from
the second retry the loop runs without segments (`segments=False`, the
stacked epochs), and from the retry after that batch by batch
(`scan_epochs=False`), on the chance that a failure which repeats comes
from the larger path: a segment holds a best-state copy and the graphs
of two variants more than an epoch does.
"""

from __future__ import annotations

import errno
import logging
import os
import time
from typing import Callable

import torch

from ..parallel.distributed import process_count
from ..cuda_graphs import GraphCaptureError

_RETRYABLE_CUDA = ("busy or unavailable",)
_RETRYABLE_ERRNO = (errno.EIO, errno.ESTALE, errno.ETIMEDOUT)


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, GraphCaptureError):
        return False
    if isinstance(exc, OSError) and exc.errno in _RETRYABLE_ERRNO:
        return True
    msg = str(exc)
    return "CUDA" in msg and any(s in msg for s in _RETRYABLE_CUDA)


def _device_round_trip(device) -> None:
    torch.ones(1, device=device).item()


def run_with_retries(run_fn: Callable, config, retries: int = 0,
                     logger: logging.Logger = None,
                     retry_backoff_s: float = 45.0,
                     _sleep=None, _probe=None, **kwargs):
    """Call `run_fn(config, **kwargs)` (loop2d.run or loop_cdr.run) and,
    after a retryable failure, call it again up to `retries` times: with
    resume=True when <weights_root>/<NAME>/latest.pth exists, else fresh
    (overwrite=True). Attempt k waits retry_backoff_s * k seconds, then
    makes one round trip to the device (a failure there propagates).
    `resume` and `overwrite` of the first attempt come from kwargs.
    _sleep and _probe replace time.sleep and the round trip in tests.
    Returns the history of the attempt that completed.

    From the second retry the loop is called with segments=False, and
    from the retry after that with scan_epochs=False, as the JAX
    package's ladder degrades (module docstring); a caller's own
    scan_epochs=False ends the ladder.

    Retries are off under several processes: a rank that resumed on its
    own would issue new collectives while the others still wait in the
    failed step's, and hang or corrupt the run. There all ranks restart
    together from the shared checkpoint (the job's restart policy and
    --resume)."""
    log = logger or logging.getLogger("fast3dhpe_tpu_torch")
    if retries and process_count() > 1:
        log.warning("--retries disabled under multi-process execution "
                    "(%d processes): in-process resume cannot rejoin the "
                    "collective gang; rely on whole-job restart with "
                    "--resume", process_count())
        retries = 0
    sleep = _sleep or time.sleep
    probe = _probe or (lambda: _device_round_trip(
        kwargs.get("device", "cuda")))
    attempt = 0
    while True:
        try:
            return run_fn(config, **kwargs)
        except Exception as e:                # noqa: BLE001 — filtered
            if attempt >= retries or not is_retryable(e):
                raise
            attempt += 1
            latest = os.path.join(kwargs.get("weights_root", "weights"),
                                  config.MODEL.NAME, "latest.pth")
            has_ckpt = os.path.isfile(latest)
            wait = retry_backoff_s * attempt
            log.warning(
                "Retryable failure (%s); %s in %.0fs (attempt %d/%d)",
                str(e).splitlines()[0][:120],
                "resuming from the last checkpoint" if has_ckpt
                else "no checkpoint yet - restarting fresh",
                wait, attempt, retries)
            if wait > 0:
                sleep(wait)
            probe()
            kwargs = dict(kwargs, resume=has_ckpt, overwrite=not has_ckpt)
            if attempt >= 2 and kwargs.get("scan_epochs") is not False:
                if kwargs.get("segments") is not False:
                    log.warning("degrading to stacked epochs "
                                "(segments=False): the failure repeats")
                    kwargs["segments"] = False
                else:
                    log.warning("degrading to per-batch execution "
                                "(scan_epochs=False)")
                    kwargs["scan_epochs"] = False
