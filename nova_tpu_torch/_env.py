"""Device selection for the port's entry points (the twin of
``nova_tpu/_env.py``).

A CUDA driver that hangs must not hang an entry point, so the card is
probed in a subprocess with a timeout (``NOVA_DEVICE_PROBE_TIMEOUT``
seconds, 120 by default) and the answer is kept for the process. The
probe asks the CUDA driver what ``torch.cuda.is_available()`` asks it
(``cuInit``, ``cuDeviceGetCount``) without importing torch, whose import
takes seconds; a torch built without CUDA still raises, in ``resolve``. A
process that already holds a CUDA context needs no probe: the card has
answered it. Where the JAX package pins the CPU with a printed notice
when its probe fails, the port raises: an entry point runs on the CPU
only when its caller passes ``device="cpu"``.

This module imports torch only in ``entry_device``: a process that only
starts others (the bench's watchdog) selects its device without it.
"""

from __future__ import annotations

import os
import subprocess
import sys

_probe_result: bool | None = None

# the probe's program: 1 when the driver initializes and counts a device
_PROBE = (
    "import ctypes\n"
    "cuda = ctypes.CDLL('libcuda.so.1')\n"
    "n = ctypes.c_int(0)\n"
    "ok = cuda.cuInit(0) == 0 and cuda.cuDeviceGetCount(ctypes.byref(n)) == 0\n"
    "print(int(ok and n.value > 0))\n"
)


def probe_timeout() -> float:
    return float(os.environ.get("NOVA_DEVICE_PROBE_TIMEOUT", "120"))


def accelerator_available(timeout_s: float | None = None) -> bool:
    """Whether a subprocess sees a CUDA device within `timeout_s` seconds
    (NOVA_DEVICE_PROBE_TIMEOUT unless given), or this process has
    initialized CUDA already. The result is cached for the life of the
    process."""
    global _probe_result
    if _probe_result is not None:
        return _probe_result
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        _probe_result = True
        return True
    if timeout_s is None:
        timeout_s = probe_timeout()
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, timeout=timeout_s, text=True)
        _probe_result = r.returncode == 0 and r.stdout.strip() == "1"
    except (OSError, subprocess.SubprocessError):
        _probe_result = False
    return _probe_result


def device_name(device=None) -> str:
    """The device an entry point runs on, by name: "cpu" only when
    `device` names the CPU, else the CUDA device named ("cuda" unless
    given) after the probe. A probe that fails or times out raises;
    nothing falls back to the CPU."""
    name = "cuda" if device is None else str(device)
    if name.split(":")[0] == "cpu":
        return "cpu"
    if not accelerator_available():
        raise RuntimeError(
            "nova_tpu_torch: no CUDA device answered the probe within "
            f"{probe_timeout():g} s (NOVA_DEVICE_PROBE_TIMEOUT); pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    return name


def entry_device(device=None):
    """device_name(device) as a torch.device (CUDA through
    ``_device.resolve``, which raises when torch cannot use it)."""
    import torch

    from nova_tpu_torch._device import resolve

    if device_name(device) == "cpu":
        return torch.device("cpu")
    return resolve(device)
