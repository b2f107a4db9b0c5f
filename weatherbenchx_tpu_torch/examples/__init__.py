"""Worked examples of the port's public API. Each runs as ``python -m
weatherbenchx_tpu_torch.examples.<name> [--device cpu]``."""

import argparse
from typing import Optional, Sequence

import torch

from weatherbenchx_tpu_torch.apps import run_evaluation


def parse_device(argv: Optional[Sequence[str]], doc: str) -> torch.device:
  """The examples' one flag, ``--device``."""
  p = argparse.ArgumentParser(description=doc.splitlines()[0])
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default; raises without a GPU) or 'cpu'")
  return run_evaluation.resolve_device(p.parse_args(argv).device)
