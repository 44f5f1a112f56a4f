"""S Y4M streams served by ``serve.serve_files(devices=[device], chunk=K)``
from named pipes: a child process (``traffic/pipes.py``) writes every input
and reads every output, outside the served process's interpreter lock.

Set-up ends when the first chunk has come out of every output; the frames
whose last byte arrives in the ``seconds`` after that count.  Then the
child closes the inputs and serving ends at the end of the shortest
stream.  Every frame of every whole chunk the server read is due; the
answers checked are each stream's last ``check_last_frames`` output frames,
byte for byte against the plain reference's decode, pipeline and encode.
Nothing grows on disk: the footage reaches the child through its stdin.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile

import numpy as np

from portbench import harness, reference
from portbench.reference import config as ref_config
from portbench.reference import image as ref_image
from portbench.reference.y4m import encode_y4m_planes
from portbench.trace import Tracer, span
from portbench.traffic import pipes
from portbench.traffic.footage import encode_c420, pingpong, render_streams


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


FRAME_DIMS = 1          # an answer is a Y4M frame's planes, flat


def footage(ctx: harness.Context) -> np.ndarray:
    """(S, L, H·W·3/2) uint8 C420 planes of every stream's footage, on the
    host."""
    import torch

    foot = render_streams(ctx.cell.traffic, ctx.setting("frame_height"),
                          ctx.setting("frame_width"), int(ctx.setting("streams")), ctx.seed,
                          ctx.device)
    return torch.stack([encode_c420(f) for f in foot]).cpu().numpy()


def reference_outputs(ctx: harness.Context, yuv: np.ndarray, first: int, count: int,
                      precision: str = "float32"):
    """(S, count, bytes): the Y4M planes of the reference's outputs of steps
    ``first ..`` of every stream: the reference decodes the same bytes,
    runs the stream-batched chunk with serving's key (``prng.key(0)``) and
    encodes what comes out."""
    import torch

    s_n, n_foot, nbytes = yuv.shape
    h, w = ctx.setting("frame_height"), ctx.setting("frame_width")
    yuv_host = torch.from_numpy(yuv)

    def frames_at(steps):
        idx = [pingpong(j, n_foot) for j in steps]
        return ref_image.yuv_flat_to_bgr(yuv_host[:, idx].to(ctx.device), h, w, True)

    rcfg = harness.stabilizer_config(ctx, ref_config)
    mode = int(ref_config.StabilizationMode[ctx.setting("mode")])
    ref = reference.chunk_outputs(rcfg, mode, frames_at, reference.prng.key(0), s_n,
                                  int(ctx.setting("chunk")), first, first + count,
                                  ctx.device, precision).cpu()
    planes = np.stack([np.frombuffer(encode_y4m_planes(f, True), np.uint8)
                       for f in ref.numpy().reshape((-1, h, w, 3))])
    return torch.from_numpy(planes.reshape(s_n, count, nbytes))


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from video_stabilization_tpu_torch import config as port_config
    from video_stabilization_tpu_torch import parallel, serve
    from video_stabilization_tpu_torch.io import native

    params = ctx.cell.params
    dev = ctx.device
    cuda = dev.type == "cuda"
    cfg = harness.stabilizer_config(ctx, port_config, static=True)
    h, w = cfg.frame_height, cfg.frame_width
    streams, k = int(ctx.setting("streams")), int(ctx.setting("chunk"))
    keep = int(params["check_last_frames"])
    yuv = footage(ctx)
    n_foot, nbytes = yuv.shape[1:]

    tmp = tempfile.mkdtemp(prefix="portbench_pipes_")
    child = None
    tracer = Tracer(dev) if ctx.trace else None
    # the traced slice and its wall and write seconds, which the write share leaves out
    traced = {"wall_s": 0.0, "write_s": 0.0, "on": False}
    a, n_trace = int(params["trace_from_call"]), int(params["trace_calls"])
    try:
        inputs = [os.path.join(tmp, f"stream{s}.y4m") for s in range(streams)]
        outdir = os.path.join(tmp, "out")
        os.mkdir(outdir)
        outputs = [os.path.join(outdir, f"stabilized_stream{s}.y4m") for s in range(streams)]
        for p in inputs + outputs:
            os.mkfifo(p)
        child = pipes.start({
            "inputs": inputs, "outputs": outputs, "streams": streams,
            "footage_frames": n_foot, "frame_bytes": nbytes, "seconds": ctx.seconds,
            "header": f"YUV4MPEG2 W{w} H{h} F{int(ctx.setting('fps'))}:1 Ip A1:1 C420jpeg\n",
            "first_out": k, "keep": keep}, np.ascontiguousarray(yuv))

        calls = 0
        orig_fn = parallel.make_sharded_offline_fn

        def traced_fn(config, mesh):
            fn = orig_fn(config, mesh)

            def call(carry, frames):
                nonlocal calls
                if tracer is not None and calls == a:
                    start_slice()
                if tracer is not None and calls == a + n_trace:
                    stop_slice(n_trace)
                calls += 1
                with span("chunk_call"):
                    return fn(carry, frames)
            return call

        def start_slice():
            traced.update(on=True, t0=harness.now())
            tracer.start()

        def stop_slice(n):
            traced["slice"] = tracer.stop(n, n * streams * k)
            traced.update(on=False, wall_s=harness.now() - traced["t0"])

        def read_span(self, *args, **kw):
            with span("serve_read"):
                return orig_read(self, *args, **kw)

        def drain_span(*args):
            t0 = harness.now()
            with span("serve_write"):
                orig_drain(*args)
            if traced["on"]:
                traced["write_s"] += harness.now() - t0

        orig_read, orig_drain = native.NativeY4MReader.read_yuv_block, serve._drain
        with contextlib.ExitStack() as stack:
            if ctx.trace:
                stack.enter_context(_patched(parallel, "make_sharded_offline_fn", traced_fn))
                stack.enter_context(_patched(native.NativeY4MReader, "read_yuv_block",
                                             read_span))
                stack.enter_context(_patched(serve, "_drain", drain_span))
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            serve.serve_files(inputs, outdir, port_config.StabilizationMode(cfg.static_mode).name,
                              chunk=k, devices=[dev], config=cfg,
                              log=lambda m: print(m, file=sys.stderr))
        if traced["on"]:        # serving ended inside the slice: its wall ends here
            t_served = harness.now()
            stop_slice(calls - a)
            traced["wall_s"] = t_served - traced["t0"]
        memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
        run_info = dict(serve.last_run)
        report, frames_back = pipes.collect(child, keep, nbytes)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()

    t_start = report["t_start"]
    t_end = t_start + ctx.seconds
    frames = sum(sum(1 for t in st if t_start < t <= t_end) for st in report["stamps"])
    due = run_info["frames"]
    failed = sum(max(0, due - n) for n in report["read"])

    # the last frames of every stream against the reference (serving's key is prng.key(0))
    n_check = min(keep, due)
    if not failed and all(n == due for n in report["read"]):
        ref = reference_outputs(ctx, yuv, due - n_check, n_check)
        prog = np.stack([np.frombuffer(b, np.uint8)[-n_check * nbytes:].reshape(n_check, nbytes)
                         for b in frames_back])
        checks = reference.checks(torch.from_numpy(prog), ref, FRAME_DIMS, params["limits"])
    else:                       # answers missing: nothing to line up
        checks = {name: {"value": 1.0, "limit": limit}
                  for name, limit in params["limits"].items()}
    checks["missing"] = {"value": failed, "limit": 0}
    return harness.Outcome(
        frames=frames, window_s=float(ctx.seconds), setup_s=t_start - ctx.t_process,
        attempted=due * streams, failed=failed, checks=checks, memory_peak_bytes=memory,
        trace=traced.get("slice"),
        layer={"write_share": (run_info["write_s"] - traced["write_s"])
               / (run_info["wall_s"] - traced["wall_s"])})

