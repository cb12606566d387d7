"""The training loop in two gloo processes on a TP mesh (1, 2): the checks
of tests/test_torch_distributed_loop.py, with the first two blocks and the
latent dense sharded over the model axis (their Adam moments too), and
the checkpoints gathered whole and re-sliced on resume."""

import torch

from tests.test_torch_distributed_loop import hold_two_process_loop

torch.set_num_threads(2)


def test_two_process_tp_loop_resumes_and_saves_whole(tmp_path):
    hold_two_process_loop(tmp_path, (1, 2), "tp")
