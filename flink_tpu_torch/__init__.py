"""flink-tpu on PyTorch and CUDA: the keyed window path ported to an NVIDIA H100.

A second package beside :mod:`flink_tpu`, which stays the reference.  Module
paths mirror the JAX package (``operators/window_agg.py``,
``state/device_keyindex.py``, ...) so each counterpart is easy to find.  The
port imports ``torch`` and numpy only: nothing of JAX and nothing of
``flink_tpu``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, which the CPU tests do): :func:`resolve_device` never
falls back silently.  A process cluster's worker runs on the device its
coordinator ships (:func:`set_process_device`): there a device nobody names
resolves to that one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

#: the device this process was started on (a process cluster's worker:
#: its ``--device``); ``None`` leaves the card as the default
_process_device: Optional[torch.device] = None


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the process device, else ``cuda``; raises when CUDA is
    asked for (or defaulted to) and no GPU is visible.  ``"cpu"`` must be
    asked for explicitly (or be the process device)."""
    if device is None:
        device = _process_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flink_tpu_torch runs on a CUDA device by default and none is "
            "visible; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_process_device(device: DeviceLike) -> torch.device:
    """Resolve ``device`` (raising as :func:`resolve_device` does) and make
    it what a device nobody names resolves to in this process."""
    global _process_device
    _process_device = resolve_device(device)
    return _process_device
