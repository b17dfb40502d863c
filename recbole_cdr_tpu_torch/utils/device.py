"""The device rule: every entry point runs on the card unless the config asks
for the CPU, and a request for the card fails when no card is present.

Under a process group (``parallel/distributed.py``) each rank runs on its
own device: ``cuda`` becomes ``cuda:<local rank>``, and the collectives ride
the backend that fits the device (NCCL for the card, gloo for the CPU)."""

import os

import torch


def resolve_device(config) -> torch.device:
    name = str(config["device"] or "cuda").lower()
    if name.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but no CUDA device is available; "
                "set device: cpu to run on the CPU"
            )
        return torch.device(name)
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device [{name}] is not supported: use 'cuda' or 'cpu'")


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of a rank: ``cuda`` without an index becomes the card of the
    process's local rank (torchrun's ``LOCAL_RANK``, else ``rank`` modulo the
    cards of the host); an indexed card and the CPU stay as they are."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """The collectives' backend for tensors on ``device``: NCCL on the card,
    gloo on the CPU (no tensor is staged from one to the other)."""
    return "nccl" if device.type == "cuda" else "gloo"
