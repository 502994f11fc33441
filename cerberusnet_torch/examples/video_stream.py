"""Real-time streaming inference: the serving loop of a live stereo camera
feed on the card, the counterpart of the JAX package's
``examples/video_stream.py``.

* One bf16 model held resident, its weights on the device: the eager
  forward with its hand kernels (K1/K4 for ``cerberus`` and ``fast``,
  K7/K8 for ``dcv``).
* Pipelined uploads: frame t + 1's uint8 triple is copied from page-locked
  host memory on a second CUDA stream while frame t computes on the
  default one, into the other of two device buffers (``Uploads``).
* uint8 -> normalised bf16 on the device, rounded as the reference's
  ``x.astype(bf16) / 255.0 - 0.5``: the cast, the division and the
  subtraction each round to bf16 (``prep``).
* Per-frame latency sampled by reading a one-pixel probe with ``.item()``,
  the completion signal; then the streamed throughput over the remaining
  frames with one read at the end; then the compute-bound rate of 10
  forwards on frames already on the device.

Run:  python -m cerberusnet_torch.examples.video_stream --frames 64 --model cerberus
      (models: cerberus | dcv | fast; --hw 512 1024; --device cpu)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.dcv_flow import CerberusDCV
from cerberusnet_torch.weights import init_params

MODELS = ("cerberus", "dcv", "fast")
FAST = dict(encoder_channels=(16, 24, 32, 48, 64, 96),
            est_channels=(64, 64, 48), ctx_channels=(64, 48),
            fpn_channels=48)
# forwards on device-resident frames for the compute-bound rate
RESIDENT_FORWARDS = 10


def make_model(name: str, dtype: torch.dtype):
    if name == "cerberus":
        return CerberusNet(dtype=dtype)
    if name == "dcv":
        return CerberusDCV(dtype=dtype)
    if name == "fast":
        return CerberusNet(dtype=dtype, **FAST)
    raise ValueError(f"unknown model {name!r}")


def load_model(name: str, device="cuda", dtype: torch.dtype = torch.bfloat16,
               seed: int = 0):
    """``make_model``'s model with weights drawn from ``seed`` (flax's
    initialisers), in evaluation mode on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to stream on the CPU")
    model = make_model(name, dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def synthetic_stream(frames: int, hw, seed: int = 0):
    """Yield (left, right, temporal) uint8 'camera' frames (host numpy)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    base = rng.randint(0, 255, (h, w, 3), np.uint8)
    for t in range(frames):
        # cheap moving scene: roll + noise, stereo shift
        left = np.roll(base, t * 2, axis=1)
        right = np.roll(left, -4, axis=1)
        temporal = np.roll(base, (t - 1) * 2, axis=1)
        yield left, right, temporal


def prep(frame, dtype: torch.dtype = torch.bfloat16):
    """A uint8 (H, W, 3) frame -> (1, H, W, 3) normalised in ``dtype``."""
    return (frame.to(dtype) / 255.0 - 0.5)[None]


def make_infer(model, dtype: torch.dtype = torch.bfloat16):
    """The forward of a (3, H, W, 3) uint8 triple on the model's device:
    (outputs, probe), the probe one pixel's class plus its flow and
    disparity."""
    @torch.inference_mode()
    def infer(triple):
        out = model(*(prep(f, dtype) for f in triple))
        probe = (out["seg_logits"][0, 0, 0].argmax().float()
                 + out["flow"][0, 0, 0, 0] + out["disp"][0, 0, 0, 0])
        return out, probe

    return infer


class Uploads:
    """Frame triples to the card on a side stream, through two page-locked
    host buffers and two device buffers used in turn. A host buffer is
    refilled only after its last copy ended (``copied``, which the host
    waits on); a device buffer is overwritten only after the forward that
    read it ended (``read``, which the copy stream waits on); a forward
    waits on its buffer's copy (``take``). ``timing``: each copy's start
    and end events; ``stage_ms``: each ``put``'s ms on the host, the
    staging copy into page-locked memory and, in ``wait_ms``, the wait for
    the buffer before it."""

    def __init__(self, hw, device):
        shape = (3, *hw, 3)
        self.host = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        # staged by numpy's one-thread copy: torch's copy_ of a frame this
        # size runs on its intra-op threads, beside the thread that
        # launches the forward
        self.staging = [h.numpy() for h in self.host]
        self.dev = [torch.empty(shape, dtype=torch.uint8, device=device)
                    for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.read = [torch.cuda.Event() for _ in range(2)]
        self.stream = torch.cuda.Stream(device)
        self.timing, self.stage_ms, self.wait_ms = [], [], []
        self.turn = 0

    def put(self, frames) -> int:
        """Starts the upload of a (left, right, temporal) triple of numpy
        uint8 frames; returns its slot."""
        i, self.turn = self.turn, self.turn ^ 1
        t0 = time.perf_counter()
        self.copied[i].synchronize()
        t1 = time.perf_counter()
        for k, f in enumerate(frames):
            np.copyto(self.staging[i][k], f)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.read[i])
            start.record(self.stream)
            self.dev[i].copy_(self.host[i], non_blocking=True)
            end.record(self.stream)
            self.copied[i].record(self.stream)
        self.timing.append((start, end))
        self.wait_ms.append((t1 - t0) * 1e3)
        self.stage_ms.append((time.perf_counter() - t0) * 1e3)
        return i

    def take(self, i: int):
        """Slot ``i``'s triple for a forward on the current stream."""
        torch.cuda.current_stream().wait_event(self.copied[i])
        return self.dev[i]

    def release(self, i: int):
        """Marks, on the current stream, the end of the forward that read
        slot ``i``."""
        self.read[i].record(torch.cuda.current_stream())

    def upload_ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.timing]


class HostFeed:
    """``Uploads``' interface on the CPU: a slot is the triple itself."""

    stage_ms = wait_ms = ()

    def put(self, frames):
        return torch.from_numpy(np.stack(frames))

    def take(self, triple):
        return triple

    def release(self, triple):
        pass

    def upload_ms(self) -> list:
        return []


def stream(model_name: str = "cerberus", frames: int = 32, hw=(512, 1024),
           latency_samples: int = 8, verbose: bool = True, device="cuda",
           model=None, keep=(), record: dict | None = None):
    """Streams ``frames`` synthetic frames through ``model_name``'s model
    (or ``model``, a loaded one) and returns the reference's stats. With
    ``record`` (a dict) it also gets the outputs of the frames in
    ``keep`` (``"outputs"``, by frame), each copy's ms on the card
    (``"upload_ms"``), each upload's ms on the host (``"stage_ms"``, of
    which ``"wait_ms"`` waiting for its buffer), the host's ms of each
    streamed frame's iteration (``"loop_ms"``: its upload and forward
    launched, not waited for) and the number of forwards run
    (``"forwards"``)."""
    device = torch.device(device)
    dtype = torch.bfloat16
    if model is None:
        model = load_model(model_name, device, dtype)
    infer = make_infer(model, dtype)
    h, w = hw
    if verbose:
        print(f"[stream] warming {model_name} up at {h}x{w} ...")
    warm = next(iter(synthetic_stream(1, hw)))
    dev = torch.from_numpy(np.stack(warm)).to(device)
    _, probe = infer(dev)
    probe.item()  # the forward really ran
    feed = Uploads(hw, device) if device.type == "cuda" else HostFeed()

    lat, kept, loop_ms = [], {}, []
    t_start = None
    n_thru = 0
    pending = None
    src = synthetic_stream(frames, hw)
    nxt = feed.put(next(src))
    for i, frame in enumerate(list(src) + [None]):
        t_iter = time.perf_counter()
        cur = nxt
        if frame is not None:
            nxt = feed.put(frame)
        if i < latency_samples:
            t0 = time.perf_counter()
            out, probe = infer(feed.take(cur))
            feed.release(cur)
            probe.item()  # read == completion
            lat.append(time.perf_counter() - t0)
        else:
            if t_start is None:
                t_start = time.perf_counter()
            out, pending = infer(feed.take(cur))
            feed.release(cur)
            n_thru += 1
            loop_ms.append((time.perf_counter() - t_iter) * 1e3)
        if i in keep:
            kept[i] = out
    if pending is not None:
        pending.item()  # drain the pipeline
        thru = n_thru / (time.perf_counter() - t_start)
    else:
        thru = None

    # Compute-bound ceiling: the same forward on device-RESIDENT frames;
    # the gap to the streamed throughput is what the uploads cost
    t0 = time.perf_counter()
    for _ in range(RESIDENT_FORWARDS):
        _, pending = infer(dev)
    pending.item()
    compute_fps = RESIDENT_FORWARDS / (time.perf_counter() - t0)

    stats = {
        "model": model_name,
        "hw": list(hw),
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "latency_ms_p99": float(np.percentile(lat, 99) * 1e3),
        "throughput_fps": thru,
        "compute_bound_fps": compute_fps,
    }
    if record is not None:
        record.update(outputs=kept, upload_ms=feed.upload_ms(),
                      stage_ms=list(feed.stage_ms), wait_ms=list(feed.wait_ms),
                      loop_ms=loop_ms, forwards=1 + frames + RESIDENT_FORWARDS)
    if verbose:
        print(f"[stream] per-frame latency p50 {stats['latency_ms_p50']:.2f} "
              f"ms, p99 {stats['latency_ms_p99']:.2f} ms (probe-synchronized,"
              f" upload included)")
        if thru:
            print(f"[stream] streamed throughput: {thru:.1f} fps | "
                  f"compute-bound (device-resident frames): "
                  f"{compute_fps:.1f} fps")
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="cerberus", choices=MODELS)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--hw", type=int, nargs=2, default=[512, 1024])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    stream(args.model, args.frames, tuple(args.hw), device=args.device)
