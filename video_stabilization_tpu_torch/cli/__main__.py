"""``python -m video_stabilization_tpu_torch.cli``: the application."""

from video_stabilization_tpu_torch.cli.app import main

if __name__ == "__main__":
    raise SystemExit(main())
