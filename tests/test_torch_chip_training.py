"""`chip_smoke.py` phase 13 (the training half) rehearsed on the CPU at a
small size: dense nf=8 units, a batch of 2 crops of 12 x 12 from a
synthetic tree written without PIL, 7 train and 2 fine-tune steps, the
deploy on one 24 x 32 frame.  The card-vs-CPU gates compare the CPU path
with itself here, so every one holds exactly; what this holds is that the
phase runs end to end and prints each reading the card run reports.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import tail_kernel as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase13_rehearsal_on_cpu(capsys):
    imgs = np.random.default_rng(0).integers(0, 256, (1, 24, 32, 3)).astype(
        np.uint8)
    cs._training_half(torch, tk, imgs, dev="cpu", sizes=dict(
        nf=8, batch=2, crop=12, steps=7, ft_steps=2, images=2, hr=64))
    out = capsys.readouterr().out
    for line in ("train step, card vs CPU: loss",
                 "train(opt): 7 steps, loss per step",
                 "transfer ftr2: 0 tie flips in all",
                 "lut_model_forward (2, 1, 48, 48): 0 values differ",
                 "fine-tune step, card vs CPU: loss",
                 "finetune(opt): 2 steps",
                 "byte-equal to the CPU path"):
        assert line in out, line
