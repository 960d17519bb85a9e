"""Device selection for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``"cuda"`` by default.

    Raises when CUDA is asked for and there is no card: the port never
    moves to the CPU on its own; a caller asks for it with ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def rank_device(device=None, *, shared: bool = False) -> torch.device:
    """The device of this rank of a process group that
    ``torch.distributed.run`` launched: ``cuda:{LOCAL_RANK}`` where
    ``device`` asks for the card (the default), the CPU where it asks for
    it. Exits when the host has fewer cards than local ranks: ranks never
    share a card unless the caller says so (``shared``, with ``device``
    the card they share)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or shared:
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if cards < local_world:
        raise SystemExit(f"{local_world} ranks on this host and {cards} "
                         f"card(s): one card a rank; to put ranks on one "
                         f"card pass the device and backend='gloo'")
    return torch.device("cuda", local_rank)
