"""The model-serving entry point (``bin/serve.py`` counterpart): loads a
checkpoint once and serves volume inference over HTTP
(``rcu_tpu_torch.serve``). Every strategy family is served: MC-dropout
(default; ``-mc 0`` deterministic), aleatoric (``-is_log_sigma`` /
``-no_log_sigma``), ensembles (``-member DIR``, repeatable), auxiliary
feat (``-segm_model_dir DIR``) and auxiliary segm (``-aux_segm``;
requests carry a ``baseline`` volume).

  python -m rcu_tpu_torch.cli.serve -model_dir out/.../model_x
      [-test_at best] [-mc 20] [-batch_size 32] [-host 0.0.0.0]
      [-port 8475] [-prewarm 155x240x240] [-member DIR ...]
      [-is_log_sigma | -no_log_sigma] [-segm_model_dir DIR | -aux_segm]
      [-dtype bfloat16] [-fast_decoder] [-fold_bn] [-quantize]
      [-device cuda|cpu] [-devices N [-throughput]]

Runs on the card unless ``-device`` names another device. ``-devices N``
serves on a mesh of N devices of ``-device``'s kind (cpu: the virtual
mesh): each request split over them (latency), or with ``-throughput``
a model copy per device and concurrent requests on different devices.
``-prewarm`` sends zero volumes through the service
before the port binds: eager PyTorch compiles no per-shape program, but
the CUDA context, cuDNN's handles and the allocator's pool are set up
before the first client waits on them. It is refused with ``-quantize``:
a quantized service calibrates int8 on its first request, and zero
volumes would give it scales that clip every real request.

Client (stdlib and numpy):
  import io, urllib.request, numpy as np
  buf = io.BytesIO(); np.savez_compressed(buf, images=volume)
  req = urllib.request.Request("http://host:8475/v1/predict",
                               data=buf.getvalue(), method="POST")
  out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
"""
import argparse
import logging

from rcu_tpu_torch.cli import _cli


def main(model_dir, test_at="best", mc=20, batch_size=32, devices=None,
         host="0.0.0.0", port=8475, prewarm=None, members=None,
         is_log_sigma=None, dtype=None, segm_model_dir=None,
         aux_segm=False, throughput=False, fast_decoder=False,
         fold_bn=False, quantize=False, device=None):
    import numpy as np

    from rcu_tpu_torch.serve import VolumeInferenceService, make_http_server

    mesh = _cli.mesh_from_devices(devices, device)
    if throughput and mesh is None:
        raise ValueError("-throughput needs -devices N > 1")
    if prewarm and quantize:
        raise ValueError(
            "-prewarm with -quantize would calibrate int8 on zero volumes "
            "(the first request calibrates): drop -prewarm")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    service = VolumeInferenceService(model_dir, test_at=test_at, mc=mc,
                                     batch_size=batch_size, members=members,
                                     is_log_sigma=is_log_sigma, dtype=dtype,
                                     segm_model_dir=segm_model_dir,
                                     aux_segm=aux_segm,
                                     fast_decoder=fast_decoder,
                                     fold_bn=fold_bn, quantize=quantize,
                                     device=device, mesh=mesh,
                                     subject_parallel=throughput)
    if prewarm:
        for spec in prewarm.split(","):
            z, h, w = (int(v) for v in spec.lower().split("x"))
            logging.info("prewarming %dx%dx%d (unscored request)...", z, h, w)
            kw = {"baseline": np.zeros((z, h, w), np.uint8)} \
                if service.strategy == "auxiliary_segm" else {}
            # one request per pool device warms every copy of the model
            for _ in range(service.pool_size):
                service.predict(np.zeros((z, h, w, service.in_channels),
                                         np.float32), **kw)
        logging.info("prewarmed shapes: %s", service.compiled_shapes())
    server = make_http_server(service, host, port)
    logging.info("serving %s [%s] (mc=%d, batch=%d) on %s at http://%s:%d",
                 model_dir, service.strategy, service.mc, service.batch_size,
                 mesh or service.device, host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MC-dropout inference server")
    parser.add_argument("-model_dir", type=str, required=True)
    parser.add_argument("-test_at", type=str, default="best",
                        help="checkpoint selector: best | last | epoch int")
    parser.add_argument("-mc", type=int, default=20)
    parser.add_argument("-batch_size", type=int, default=32)
    parser.add_argument("-devices", type=int, default=None,
                        help="serve on a mesh of N devices of -device's "
                             "kind (default: one device)")
    parser.add_argument("-host", type=str, default="0.0.0.0")
    parser.add_argument("-port", type=int, default=8475)
    parser.add_argument("-prewarm", type=str, default=None,
                        help="comma-separated ZxHxW volume shapes sent as "
                             "zero volumes before the port binds, e.g. "
                             "155x240x240 (not with -quantize)")
    parser.add_argument("-member", type=str, action="append", default=None,
                        help="additional ensemble member model dir "
                             "(repeatable; model_dir is the primary member)")
    parser.add_argument("-is_log_sigma", dest="is_log_sigma",
                        action="store_true", default=None,
                        help="the sigma head emits log(sigma) (aleatoric "
                             "checkpoints; required for them)")
    parser.add_argument("-no_log_sigma", dest="is_log_sigma",
                        action="store_false",
                        help="the sigma head emits raw sigma")
    parser.add_argument("-dtype", type=str, default=None,
                        help="compute dtype, e.g. bfloat16 (the production "
                             "dtype)")
    parser.add_argument("-segm_model_dir", type=str, default=None,
                        help="auxiliary-feat: the frozen segmenter's model "
                             "dir (model_dir then holds the PostNet)")
    parser.add_argument("-aux_segm", action="store_true",
                        help="auxiliary-segm error net: requests must carry "
                             "a 'baseline' prediction volume")
    parser.add_argument("-fast_decoder", action="store_true",
                        help="concat-free + fused-upsample U-Net decoder")
    parser.add_argument("-fold_bn", action="store_true",
                        help="fold BatchNorms into convs at load "
                             "(deterministic strategies only, not mc>0)")
    parser.add_argument("-quantize", action="store_true",
                        help="int8 PTQ trunk (mc/deterministic/ensemble "
                             "only): calibrates on the first request's "
                             "centre slices")
    parser.add_argument("-throughput", action="store_true",
                        help="with -devices N: a model copy per device "
                             "and concurrent requests on different devices "
                             "instead of splitting each request")
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default cuda)")
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    main(args.model_dir, args.test_at, args.mc, args.batch_size,
         args.devices, args.host, args.port, args.prewarm, args.member,
         args.is_log_sigma, args.dtype, args.segm_model_dir, args.aux_segm,
         args.throughput, args.fast_decoder, args.fold_bn, args.quantize,
         args.device)


if __name__ == "__main__":
    cli()
