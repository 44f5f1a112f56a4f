"""Command-line application mirroring the reference's flags and controls."""

from video_stabilization_tpu_torch.cli.args import parse_args  # noqa: F401
from video_stabilization_tpu_torch.cli.app import main  # noqa: F401
