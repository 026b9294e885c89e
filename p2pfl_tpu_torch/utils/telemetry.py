"""Host and device resource telemetry.

The counterpart of ``p2pfl_tpu/utils/telemetry.py``, logged as
``Resources/*`` each round: CPU, RAM, disk and network from psutil
(optional, skipped without it), and each CUDA device's memory from
``torch.cuda`` under the JAX package's key names
(``Resources/device{i}_hbm_used_mb``, ``_hbm_limit_mb``), so that the
two packages' logs line up.
"""

from __future__ import annotations

import torch


def resource_snapshot() -> dict[str, float]:
    """One sample of CPU/RAM/disk/net and per-device memory."""
    out: dict[str, float] = {}
    try:
        import psutil

        out["Resources/cpu_percent"] = psutil.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        out["Resources/ram_percent"] = vm.percent
        out["Resources/ram_used_gb"] = vm.used / 2**30
        du = psutil.disk_usage("/")
        out["Resources/disk_percent"] = du.percent
        net = psutil.net_io_counters()
        out["Resources/net_sent_mb"] = net.bytes_sent / 2**20
        out["Resources/net_recv_mb"] = net.bytes_recv / 2**20
    except Exception:  # psutil is optional: never break a round over it
        pass
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"Resources/device{i}_hbm_used_mb"] = (
                torch.cuda.memory_allocated(i) / 2**20)
            out[f"Resources/device{i}_hbm_limit_mb"] = (
                torch.cuda.mem_get_info(i)[1] / 2**20)
    return out
