"""Serving: a persistent volume inference service and its HTTP front
(``rcu_tpu.serve`` counterpart: the same constructor, ``predict``
signature, wire format and HTTP codes).

The service loads a checkpoint once and answers requests with the
strategy's per-voxel artifacts, optionally scored against a ground truth
by the direct eval's protocol (``eval.pipeline``: the family's forwards,
then one launch of the fused eval kernel). Every checkpoint family is
served, detected as the JAX service detects it:

- **MC-dropout** (default): prediction, foreground probabilities and the
  entropy in bits; ``mc=0`` serves the deterministic protocol;
- **aleatoric** (a sigma-headed checkpoint; ``is_log_sigma`` required):
  adds the unrescaled predicted-class ``sigma``; ``sigma_min`` and
  ``sigma_max`` (the run's global bounds) add the folded ``confidence``,
  and are required to score;
- **ensemble** (``members=[model_dir, ...]``): the member-mean
  probabilities and entropy; the members run one after another, as the
  port's direct eval runs them;
- **auxiliary_feat** (``segm_model_dir``; ``model_dir`` holds the
  PostNet): the PostNet's confidence and the frozen segmenter's argmax;
- **auxiliary_segm** (``aux_segm=True``): the error net's confidence over
  the images and the request's ``baseline``, which comes back as the
  prediction.

Wire protocol (stdlib on both ends; arrays ride npz):
  POST /v1/predict  body: ``.npz`` with ``images`` [Z,H,W,C] (or [H,W,C])
                    float32, optional ``target`` [Z,H,W] and, only with a
                    target, ``mask`` [Z,H,W] (it gates the eval reductions,
                    never the artifacts), optional ``sigma_min`` /
                    ``sigma_max`` scalars (aleatoric), ``baseline`` [Z,H,W]
                    (auxiliary_segm, required there) and a ``per_image``
                    flag (the leading axis holds independent images, each
                    scored on its own: ``ece``/``dice`` vectors and
                    ``correction_*`` [K,11], no artifacts). Returns ``.npz``
                    with the artifacts and, when a target was sent, ``ece``
                    and the per-threshold ``correction_*`` vectors. The
                    response's ``Server-Timing`` header gives the request's
                    npz decode, device work and npz encode times in ms.
  GET  /v1/health   -> JSON {status, model_dir, strategy, mc, members,
                    batch_size, compiled_shapes}

One device, or a mesh (``parallel.Mesh``) in the JAX service's two modes:
- latency (``mesh``): the batch rule rounds up to the mesh's data axis,
  and each request's batches split over its data devices, each with its
  own copy of the models (``eval.pipeline``'s mesh path: one eval kernel
  launch per data device, the maps copied to the host once per device);
  an ensemble's members go over the model axis of a 2-D mesh;
- throughput (``subject_parallel=True``): a copy of the models per mesh
  device, and each request checks a free device out of a queue
  (``pool_size`` of them) and runs whole on it. Request ``i`` draws the
  stream ``(seed, i)`` whichever device answers it.
A quantized service calibrates int8 once, on the first request, on the
first device, under a service-wide lock; the quantized copies are made
after it.

Threads: a request's device work (the copies in, the forwards, the eval
kernel, the copies out) runs under one lock (latency mode and one
device) or on its checked-out device (throughput mode), with cuDNN's and
cuBLAS's TF32 off inside it (``eval.device.full_float32``, which keeps
the flags off while any thread's block is open): the flags are global to
the process, and a handler thread that restored them while another was
mid-forward would move that request's f32 logits past the f32 bar. Host
work (npz decode and encode, binarizing targets, pinning the input)
stays outside, so concurrent requests overlap there.
"""
from __future__ import annotations

import collections
import io
import json
import logging
import queue
import threading
import time
import zipfile

import numpy as np
import torch

from rcu_tpu_torch.engine import checkpoint as ckpt_lib
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.eval.device import Fetch, full_float32
from rcu_tpu_torch.eval.direct import load_model, run_device
from rcu_tpu_torch.ops import prepare
from rcu_tpu_torch.ops import quant as quant_ops
from rcu_tpu_torch.parallel.mesh import pad_batch_size_to_mesh

DEFAULT_THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)


class VolumeInferenceService:
    """Checkpoint(s) -> a model (or an ensemble's members) held on one
    device or a mesh (see the module doc), answering :meth:`predict`
    calls.

    Eager PyTorch compiles nothing per request shape, so the port keeps no
    program cache. :meth:`compiled_shapes` still reports the request
    shapes served, under the JAX service's labels (``"155-slices-b32"``
    unscored, keyed on the slice count padded to the batch;
    ``"155-slices-b32-scored"``; ``"per-image"``), in a bounded LRU of
    ``max_programs`` entries, as the ``/v1/health`` record of what the
    server has answered."""

    def __init__(self, model_dir: str, test_at="best", mc: int = 20,
                 batch_size: int = 32, mesh=None,
                 thresholds=DEFAULT_THRESHOLDS, seed: int = 0,
                 members: list = None, is_log_sigma: bool = None,
                 max_programs: int = 32, dtype: str = None,
                 segm_model_dir: str = None, aux_segm: bool = False,
                 subject_parallel: bool = False,
                 fast_decoder: bool = False,
                 fold_bn: bool = False,
                 quantize: bool = False,
                 device=None):
        self.device = run_device(device, mesh)
        self.model_dir = model_dir
        self.mc = int(mc)
        self.seed = int(seed)
        self.thresholds = np.asarray(thresholds, np.float32)
        self.batch_size = int(batch_size)
        self.subject_parallel = bool(subject_parallel and mesh is not None)
        # the latency mesh; throughput mode runs single-device requests
        self.mesh = None if self.subject_parallel else mesh
        if self.mesh is not None:
            self.batch_size = pad_batch_size_to_mesh(self.batch_size,
                                                     self.mesh)
        self._pool_devices = mesh.devices if self.subject_parallel \
            else (self.device,)
        self.max_programs = int(max_programs)
        self.members = list(members or [])
        if sum(map(bool, (self.members, segm_model_dir, aux_segm))) > 1:
            raise ValueError("members, segm_model_dir and aux_segm select "
                             "mutually exclusive serving strategies")
        self.in_channels = _record_in_channels(model_dir)
        variant = dict(dtype=dtype, fast_decoder=fast_decoder,
                       fold_bn=fold_bn)
        self.model = load_model(model_dir, test_at, self.device, **variant)
        self.segm_model = None
        if self.members:
            self.strategy = "ensemble"
            self.models = [self.model] + [
                load_model(d, test_at, self.device, **variant)
                for d in self.members]
        elif segm_model_dir:
            # auxiliary_feat: model_dir holds the PostNet, segm_model_dir
            # the frozen segmenter whose features feed it
            self.strategy = "auxiliary_feat"
            self.segm_model = load_model(segm_model_dir, test_at, self.device,
                                         provide_features=True, **variant)
            self.in_channels = _record_in_channels(segm_model_dir)
            self.models = (self.segm_model, self.model)
        elif aux_segm:
            self.strategy = "auxiliary_segm"
            # the error net reads images + the baseline channel; clients
            # send the raw image channels and the baseline apart
            self.in_channels = max(1, self.in_channels - 1)
            self.models = self.model
        elif getattr(self.model, "sigma_out", False):
            if is_log_sigma is None:
                raise ValueError(
                    f"{model_dir} is a sigma-headed (aleatoric) checkpoint: "
                    "pass is_log_sigma explicitly (it is a training-config "
                    "property the checkpoint cannot carry)")
            self.strategy = "aleatoric"
            self.models = self.model
        else:
            self.strategy = "mc"
            self.models = self.model
        self.is_log_sigma = bool(is_log_sigma) if is_log_sigma is not None \
            else None
        if fold_bn and self.strategy == "mc" and self.mc > 0:
            raise ValueError(
                "fold_bn covers the deterministic single-forward serving "
                "strategies (mc=0/ensemble/aleatoric/auxiliary_*); the "
                "mc protocol samples dropout, which the BN fold cannot "
                "commute with")
        self._quant_ready = not quantize
        if quantize and self.strategy not in ("mc", "ensemble"):
            raise ValueError(
                "quantize=True covers the mc/deterministic/ensemble "
                f"serving strategies; '{self.strategy}' keeps the "
                "f32/bf16 paths")
        readers = self.models if self.strategy == "ensemble" else \
            [self.segm_model or self.model]
        self._input_dtype = readers[0].dtype
        self._shapes = collections.OrderedDict()  # bounded LRU of labels
        self._requests = 0
        self._lock = threading.Lock()        # device work (latency mode)
        self._cache_lock = threading.Lock()  # shapes LRU, request counter
        self._placed = None                  # the models on the devices
        self._pool = queue.Queue()           # free devices (throughput)
        for i in range(len(self._pool_devices)):
            self._pool.put(i)
        if self._quant_ready:
            self._place()

    @property
    def pool_size(self) -> int:
        """Devices answering requests at once (1 outside throughput
        mode)."""
        return len(self._pool_devices)

    def _place(self):
        """The models where the requests run: per pool device its copy
        (throughput), placed on the mesh (latency), or as loaded."""
        if self.subject_parallel:
            self._placed = pipeline.replicas(self.strategy, self.models,
                                             self._pool_devices)
        elif self.mesh is not None:
            self._placed = [pipeline.place(self.strategy, self.models,
                                           self.mesh)]
        else:
            self._placed = [self.models]

    # ------------------------------------------------------------ bookkeeping
    def _effective_batch(self, nz: int) -> int:
        """Shrink the slice batch to the volume: ``min(batch_size, the next
        power of two >= nz)``, so a 1-slice request runs at batch 1. The
        ragged last batch runs as a smaller batch, as the direct eval runs
        it: a 155-slice request at batch 32 gives 32, 32, 32, 32, 27. On a
        latency mesh the batch rounds up to the data axis."""
        batch = min(self.batch_size, 1 << max(0, nz - 1).bit_length())
        if self.mesh is not None:
            batch = pad_batch_size_to_mesh(batch, self.mesh)
        return batch

    def _served(self, key):
        with self._cache_lock:
            self._shapes[key] = None
            self._shapes.move_to_end(key)
            while len(self._shapes) > self.max_programs:
                evicted, _ = self._shapes.popitem(last=False)
                logging.info("serve: evicted served shape %s (cap %d)",
                             evicted, self.max_programs)

    def compiled_shapes(self):
        """The labels of the request shapes served (see the class doc)."""
        def label(nz, ev, batch):
            if ev == "per_image":
                return "per-image"
            return f"{nz}-slices-b{batch}{'-scored' if ev else ''}"
        with self._cache_lock:
            keys = list(self._shapes)
        return sorted(label(*key) for key in keys)

    def _next_request(self) -> int:
        with self._cache_lock:
            self._requests += 1
            return self._requests

    # ----------------------------------------------------------- device work
    def _host_tensor(self, array, dtype=None):
        """A host tensor of ``array`` (cast to ``dtype``), pinned when the
        device is a card, so that its copy to the card runs without
        blocking."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if dtype is not None:
            t = t.to(dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _images(self, images):
        """The request's images as a host tensor; on a latency mesh cast
        to the models' compute dtype here (each device copies its rows),
        else on the device (:meth:`_on_device`)."""
        return self._host_tensor(images, None if self.mesh is None
                                 else self._input_dtype)

    def _on_device(self, host: dict, device) -> dict:
        """The host tensors on ``device`` (None: a latency mesh, whose
        devices copy their rows), the images cast to the models' compute
        dtype."""
        if device is None:
            return host
        out = {k: v.to(device, non_blocking=True) for k, v in host.items()}
        out["images"] = out["images"].to(self._input_dtype)
        return out

    def _ensure_quant_calibrated(self, volume: np.ndarray):
        """First-request int8 calibration (``quantize=True`` services).

        The service has no dataset, so the centre ``min(batch_size, Z)``
        slices of the first request are the calibration batch, as the
        direct eval takes the centre slices of its first subject. One model
        calibrates under one dropout sample (a generator seeded with the
        service's seed) when ``mc > 0`` and deterministically when
        ``mc == 0``; an ensemble calibrates each member deterministically
        and merges the scales by max (``ops.quant.calibrate_and_quantize``,
        skip :data:`ops.quant.DEFAULT_SKIP_LEVELS`). Checked again under
        the device lock, so two concurrent first requests calibrate once,
        and no request runs before the models are quantized."""
        if self._quant_ready:
            return
        with self._lock:
            if self._quant_ready:
                return
            n = max(1, min(self.batch_size, len(volume)))
            lo = max(0, (len(volume) - n) // 2)
            batch = self._on_device(
                {"images": self._host_tensor(volume[lo:lo + n])},
                self.device)["images"]
            members = self.models if self.strategy == "ensemble" \
                else [self.model]
            with full_float32():
                scales, skip = quant_ops.calibrate_and_quantize(
                    members, batch,
                    self.seed if self.strategy == "mc" and self.mc > 0
                    else None)
            self._place()
            self._quant_ready = True
            logging.info("serve: int8 calibrated %d conv sites from the "
                         "first request (%d items; %d finest levels kept "
                         "in the compute dtype)", len(scales), n, skip)

    def _run(self, fn, host: dict):
        """``fn(tensors, models, mesh)`` with TF32 off: on a device checked
        out of the pool (throughput mode), else under the device lock;
        its results reach the host in one copy per device. -> (numpy
        results, device seconds: CUDA events around the copies and the
        work on a card; the wall clock to the host results on the CPU
        and on a latency mesh, whose work spans several streams)."""
        if self.subject_parallel:
            i = self._pool.get()
            try:
                return self._work(fn, host, self._placed[i],
                                  self._pool_devices[i])
            finally:
                self._pool.put(i)
        with self._lock:
            return self._work(fn, host, self._placed[0],
                              None if self.mesh is not None else self.device)

    def _work(self, fn, host, models, device):
        events = device is not None and device.type == "cuda"
        if events:
            stream = torch.cuda.current_stream(device)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
        t0 = time.perf_counter()
        with full_float32():
            fetch = Fetch(fn(self._on_device(host, device), models,
                             self.mesh))
        if events:
            end.record(stream)
        out = fetch.result()
        if events:
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        return out, time.perf_counter() - t0

    # ---------------------------------------------------------------- predict
    @staticmethod
    def _binarized(arr, want, name):
        arr = (np.asarray(arr) > 0.5).astype(np.uint8)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.shape != want:
            raise ValueError(f"{name} shape {arr.shape} does not match the "
                             f"request's {want}")
        return arr

    @classmethod
    def _scored_arrays(cls, target, mask, want):
        target = cls._binarized(target, want, "target")
        m = np.ones(want, bool) if mask is None \
            else np.asarray(mask).reshape(want) > 0
        return target, m

    def _checked_images(self, images, what):
        images = np.asarray(images, np.float32)
        if images.ndim == 3:          # single image -> one-slice volume
            images = images[None]
        if images.ndim != 4:
            raise ValueError(f"images must be [{what},H,W,C] or [H,W,C], got "
                             f"shape {images.shape}")
        if images.size == 0:
            raise ValueError(f"images array is empty: shape {images.shape}")
        if images.shape[-1] != self.in_channels:
            raise ValueError(
                f"images have {images.shape[-1]} channels but the served "
                f"checkpoint expects {self.in_channels}")
        return images

    def predict(self, images: np.ndarray, target: np.ndarray = None,
                mask: np.ndarray = None, sigma_bounds=None,
                baseline: np.ndarray = None,
                per_image: bool = False) -> dict:
        """One volume in, the strategy's serving artifacts out (numpy).
        Thread-safe.

        ``per_image=True`` scores the leading axis as K independent images,
        each with its own eval row (``ece``/``dice`` vectors,
        ``correction_*`` [K, 11]), from one forward batch of all K images
        and one eval kernel launch; scores only. The K images (times the MC
        samples) ride one forward, as the JAX program runs them, so the
        client chooses K, and with it the request's device memory."""
        return self.predict_timed(images, target, mask, sigma_bounds,
                                  baseline, per_image)[0]

    def predict_timed(self, images, target=None, mask=None, sigma_bounds=None,
                      baseline=None, per_image=False):
        """:meth:`predict` -> (its result, the request's device seconds)."""
        if self.strategy == "auxiliary_segm" and baseline is None:
            raise ValueError(
                "an auxiliary-segm service scores a BASELINE segmentation: "
                "send its prediction volume as 'baseline'")
        if baseline is not None and self.strategy != "auxiliary_segm":
            raise ValueError("'baseline' only applies to an auxiliary-segm "
                             f"service; this server runs '{self.strategy}'")
        if target is None and mask is not None:
            raise ValueError(
                "a mask without a target has no effect: masks only gate the "
                "eval reductions (ece), never the prediction artifacts — "
                "send a target to score, or drop the mask")
        if sigma_bounds is not None:
            if self.strategy != "aleatoric":
                raise ValueError("sigma_min/sigma_max only apply to an "
                                 "aleatoric (sigma-headed) service; this "
                                 f"server runs '{self.strategy}'")
            smin, smax = (float(sigma_bounds[0]), float(sigma_bounds[1]))
            if not smax > smin:
                raise ValueError(f"degenerate sigma bounds [{smin}, {smax}]")
            sigma_bounds = (np.float32(smin), np.float32(smax))
        if target is not None and self.strategy == "aleatoric" \
                and sigma_bounds is None:
            raise ValueError(
                "scoring an aleatoric request needs the run-level global "
                "sigma bounds: send sigma_min/sigma_max (the offline "
                "protocol's minmax pass over the whole run)")
        if per_image:
            return self._predict_per_image(images, target, mask,
                                           sigma_bounds, baseline)
        volume = self._checked_images(images, "Z")
        nz = volume.shape[0]
        want = (nz,) + volume.shape[1:3]
        host = {"images": self._images(volume)}
        if baseline is not None:
            host["baseline"] = self._host_tensor(
                self._binarized(baseline, want, "baseline"))
        scored = target is not None
        if scored:
            t, m = self._scored_arrays(target, mask, want)
            host.update(target=self._host_tensor(t), mask=self._host_tensor(m))
        self._ensure_quant_calibrated(volume)
        batch = self._effective_batch(nz)
        self._served((nz, True, batch) if scored
                     else (-(-nz // batch) * batch, False, batch))
        rng = (self.seed, self._next_request())
        out, device_s = self._run(
            lambda data, models, mesh: self._volume_call(
                data, models, mesh, batch, scored, rng, sigma_bounds), host)
        return self._host_result(out, scored, sigma_bounds), device_s

    def _volume_call(self, data, models, mesh, batch, scored, rng,
                     sigma_bounds):
        """The pipeline function of the service's family on one request's
        tensors and the models where it runs: the artifacts only, or with
        ``scored`` the eval dict with the artifacts."""
        images = data["images"]
        if not scored:
            if self.strategy == "mc":
                return pipeline.volume_mc(models, self.mc, batch, images, rng,
                                          mesh=mesh)
            if self.strategy == "aleatoric":
                return pipeline.volume_aleatoric(models, batch, images,
                                                 self.is_log_sigma, mesh=mesh)
            if self.strategy == "ensemble":
                return pipeline.volume_ensemble(models, batch, images,
                                                mesh=mesh)
            if self.strategy == "auxiliary_feat":
                return pipeline.volume_aux_feat(*models, batch, images,
                                                mesh=mesh)
            return pipeline.volume_aux_segm(models, batch, images,
                                            data["baseline"], mesh=mesh)
        common = (data["target"], data["mask"], self.thresholds)
        kw = {"artifacts": True, "mesh": mesh}
        if self.strategy == "mc":
            return pipeline.volume_mc_eval(models, self.mc, batch, images,
                                           *common, rng, **kw)
        if self.strategy == "aleatoric":
            return pipeline.volume_aleatoric_eval(
                models, batch, images, *common, *sigma_bounds,
                self.is_log_sigma, **kw)
        if self.strategy == "ensemble":
            return pipeline.volume_ensemble_eval(models, batch, images,
                                                 *common, **kw)
        if self.strategy == "auxiliary_feat":
            return pipeline.volume_aux_feat_eval(*models, batch, images,
                                                 *common, **kw)
        return pipeline.volume_aux_segm_eval(models, batch, images,
                                             data["baseline"], *common, **kw)

    def _predict_per_image(self, images, target, mask, sigma_bounds,
                           baseline):
        """Per-image scoring (the native-2D eval protocol): K independent
        images in one call of ``pipeline.image_batch_*_eval``."""
        if target is None:
            raise ValueError(
                "per_image requests are scored-only: send targets [K,H,W] "
                "(use a plain request for the per-voxel artifacts)")
        images = self._checked_images(images, "K")
        want = (images.shape[0],) + images.shape[1:3]
        t, m = self._scored_arrays(target, mask, want)
        host = {"images": self._images(images),
                "target": self._host_tensor(t), "mask": self._host_tensor(m)}
        if baseline is not None:
            host["baseline"] = self._host_tensor(
                self._binarized(baseline, want, "baseline"))
        self._ensure_quant_calibrated(images)
        self._served((0, "per_image", 0))
        rng = (self.seed, self._next_request())
        out, device_s = self._run(
            lambda data, models, mesh: self._image_call(
                data, models, mesh, rng, sigma_bounds), host)
        result = {"ece": np.asarray(out["ece"], np.float32),
                  "dice": np.asarray(out["dice"], np.float32)}
        result.update(_correction(out))
        return result, device_s

    def _image_call(self, data, models, mesh, rng, sigma_bounds):
        common = (data["target"], data["mask"], self.thresholds)
        images = data["images"]
        if self.strategy == "mc":
            return pipeline.image_batch_mc_eval(models, self.mc, images,
                                                *common, rng, mesh=mesh)
        if self.strategy == "aleatoric":
            return pipeline.image_batch_aleatoric_eval(
                models, images, *common, *sigma_bounds, self.is_log_sigma,
                mesh=mesh)
        if self.strategy == "ensemble":
            return pipeline.image_batch_ensemble_eval(models, images, *common,
                                                      mesh=mesh)
        if self.strategy == "auxiliary_feat":
            return pipeline.image_batch_aux_feat_eval(*models, images,
                                                      *common, mesh=mesh)
        return pipeline.image_batch_aux_segm_eval(models, images,
                                                  data["baseline"], *common,
                                                  mesh=mesh)

    def _host_result(self, out, scored, sigma_bounds):
        """The request's numpy results, in the JAX service's keys and
        dtypes (``rcu_tpu.serve``'s ``_host_result``)."""
        if self.strategy in ("auxiliary_feat", "auxiliary_segm"):
            result = {"prediction": out["prediction"].astype(np.uint8),
                      "confidence": out["confidence"].astype(np.float32)}
        elif self.strategy == "aleatoric":
            prediction, sigma = out["prediction"], out["sigma"]
            confidence = out.get("confidence")
            if not scored and sigma_bounds is not None:
                # fold on the host, as the JAX service does
                confidence = prepare.fold_sigma_host(sigma, prediction,
                                                     *sigma_bounds)
            result = {"prediction": prediction.astype(np.uint8),
                      "sigma": sigma.astype(np.float32)}
            if not scored:
                result["probabilities"] = out["fg"].astype(np.float32)
            if confidence is not None:
                result["confidence"] = confidence.astype(np.float32)
        else:
            fg = out["fg"].astype(np.float32)
            result = {"prediction": (fg > 0.5).astype(np.uint8),
                      "probabilities": fg,
                      "entropy": out["entropy"].astype(np.float32)}
        if scored:
            result["ece"] = np.float32(out["ece"])
            result.update(_correction(out))
        return result


def _correction(out) -> dict:
    """The threshold correction's entries as ``correction_*`` arrays, the
    counts in float32 as the JAX service sends them (exact below 2^24
    voxels)."""
    return {f"correction_{key}": value.astype(np.float32)
            if value.dtype.kind in "iu" else value
            for key, value in out["correction"].items()}


def _record_in_channels(model_dir) -> int:
    """The ``in_channels`` of a model dir's model.json (default 4)."""
    model_node, _ = ckpt_lib.load_model_parameters(
        ckpt_lib.ModelFiles.from_model_dir(model_dir))
    return int(model_node.params.get("in_channels", 4))


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _request_arrays(body: bytes) -> dict:
    """Every array of a request's npz, decoded (``np.load`` of an npz
    decompresses an entry when it is read)."""
    payload = np.load(io.BytesIO(body), allow_pickle=False)
    if not isinstance(payload, np.lib.npyio.NpzFile):
        raise ValueError("the request body is not an .npz archive")
    with payload:
        return {k: payload[k] for k in payload.files}


def make_http_server(service: VolumeInferenceService, host: str = "0.0.0.0",
                     port: int = 8475):
    """A ready-to-``serve_forever()`` ThreadingHTTPServer around the
    service."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to logging, not stderr
            logging.info("serve: " + fmt, *args)

        def _send(self, code, body: bytes, content_type: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/v1/health":
                return self._send(404, b'{"error": "not found"}',
                                  "application/json")
            body = json.dumps({
                "status": "ok",
                "model_dir": service.model_dir,
                "strategy": service.strategy,
                "mc": service.mc,
                # model_dir's own model is member 0
                "members": (len(service.members) + 1
                            if service.members else 0),
                "batch_size": service.batch_size,
                "compiled_shapes": service.compiled_shapes(),
            }).encode()
            self._send(200, body, "application/json")

        def do_POST(self):
            if self.path != "/v1/predict":
                return self._send(404, b'{"error": "not found"}',
                                  "application/json")
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                t0 = time.perf_counter()
                payload = _request_arrays(body)
                decode_s = time.perf_counter() - t0
                if "images" not in payload:
                    raise ValueError('request .npz is missing "images"')
                sigma_bounds = None
                if "sigma_min" in payload or "sigma_max" in payload:
                    if not ("sigma_min" in payload
                            and "sigma_max" in payload):
                        raise ValueError("sigma_min and sigma_max must be "
                                         "sent together")
                    sigma_bounds = (float(payload["sigma_min"]),
                                    float(payload["sigma_max"]))
                result, device_s = service.predict_timed(
                    payload["images"], target=payload.get("target"),
                    mask=payload.get("mask"), sigma_bounds=sigma_bounds,
                    baseline=payload.get("baseline"),
                    per_image=bool(payload["per_image"])
                    if "per_image" in payload else False)
            except (ValueError, KeyError, OSError,
                    zipfile.BadZipFile) as exc:
                # malformed payloads, bad shapes: the client's fault
                logging.exception("serve: bad request")
                return self._send(400, json.dumps(
                    {"error": str(exc)}).encode(), "application/json")
            except Exception as exc:
                # device OOM, kernel failures, bugs: a server fault, so
                # retry logic and monitoring see a 5xx, not a 400
                logging.exception("serve: internal failure")
                return self._send(500, json.dumps(
                    {"error": str(exc)}).encode(), "application/json")
            t0 = time.perf_counter()
            response = _npz_bytes(result)
            encode_s = time.perf_counter() - t0
            timing = ", ".join(f"{name};dur={seconds * 1e3:.3f}" for name,
                               seconds in (("decode", decode_s),
                                           ("device", device_s),
                                           ("encode", encode_s)))
            self._send(200, response, "application/octet-stream",
                       [("Server-Timing", timing)])

    return ThreadingHTTPServer((host, port), Handler)
