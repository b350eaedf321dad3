"""The card a measurement ran on, as the port's tools record it beside
every number: `nvidia-smi`'s name and power limit and the torch and CUDA
versions.  Without a card it raises: a measurement never falls back to
the CPU."""

from __future__ import annotations

import subprocess

import torch


def card_info() -> dict:
    """{"card": "<name>, <power limit>" as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints it for
    card 0, "kind": torch's name of the card, "torch", "cuda"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "False): this measurement runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return {"card": smi.stdout.strip().splitlines()[0],
            "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda}
