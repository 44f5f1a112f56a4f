"""Frame sources and sinks, and the native Y4M ingest."""

from video_stabilization_tpu_torch.io.video import (  # noqa: F401
    CameraSource,
    FileSource,
    FrameSource,
    SimulatorSource,
    VideoWriter,
    open_source,
)
