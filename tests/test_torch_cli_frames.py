"""The port's CLI against the JAX package's, continued from
``test_torch_cli.py``: the other subcommands' headless frames (``--frames
3 --device cpu``), each ending on the reference's ``_make_step`` state to
1e-10 and printing the reference's text; with ``--method gauss4`` and a
fixed ``--dt``."""

import pytest

from test_torch_cli import FRAMES_B, check_frames


@pytest.mark.parametrize("argv", FRAMES_B, ids=[" ".join(a) for a in FRAMES_B])
def test_headless_frames_match_the_reference(argv):
    check_frames(argv)
