"""Multi-host runtime initialization.

No reference equivalent (supereight is single-process). With several
processes (one per host, or one per GPU) each runs the same program;
``jax.distributed.initialize`` wires them into one runtime so
``jax.devices()`` spans every process's devices and the shardings in
parallel/sharding.py become cross-process collectives. One process
driving all GPUs of one host needs none of this.

Typical launch (one process per host; nothing in the environment tells
JAX of a cluster, so every process is given all three variables):
  SE_COORDINATOR=host0:8476 SE_NUM_PROCESSES=4 SE_PROCESS_ID=<i> \
      python -m supereight_tpu.cli ...
"""

import os

import jax


def initialize_from_env() -> bool:
    """Initialize jax.distributed from the SE_COORDINATOR,
    SE_NUM_PROCESSES and SE_PROCESS_ID env vars; no-op when
    SE_COORDINATOR is unset (one process) or already initialized.
    Returns multi-process-ness.
    """
    coord = os.environ.get("SE_COORDINATOR")
    if not coord:
        return False
    n = int(os.environ.get("SE_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("SE_PROCESS_ID", "0"))
    try:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=n, process_id=pid)
    except RuntimeError:
        # already initialized
        pass
    return n > 1


def is_primary() -> bool:
    return jax.process_index() == 0


def scaling_report(frame_seconds: float, n_frames: int):
    """Frames/s + per-host share for the scaling-efficiency sweep
    (BASELINE.md target: >= 0.8 scaling efficiency across hosts)."""
    fps = n_frames / frame_seconds if frame_seconds > 0 else 0.0
    return {
        "fps": fps,
        "hosts": jax.process_count(),
        "devices": jax.device_count(),
        "fps_per_device": fps / max(jax.device_count(), 1),
    }
