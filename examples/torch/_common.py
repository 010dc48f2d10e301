"""The ``--device`` flag the torch examples share (default ``cuda``): a run
where CUDA is absent stops unless ``--device cpu`` was given."""

import argparse

import torch


def example_device(doc: str) -> torch.device:
    """Parse ``--device`` for the example whose docstring is `doc`."""
    parser = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    device = torch.device(parser.parse_args().device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the CPU")
    return device
