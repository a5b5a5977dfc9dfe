"""Serving CLI (``semseg_tpu/cli/serve.py``): segmentation over HTTP with
dynamic micro-batching (``semseg_tpu_torch/server.py``), on one card, from
either backend:

  # exported bundle (python -m semseg_tpu_torch.tools.export_serving) —
  # no model zoo on the serving host:
  python -m semseg_tpu_torch.cli.serve --bundle ./bundle --port 8000

  # live engine — the full 5-scale-TTA eval protocol:
  python -m semseg_tpu_torch.cli.serve --cfg config/ade20k-resnet50dilated-ppm_deepsup.yaml \\
      DIR ckpt TEST.checkpoint epoch_20.pth

  curl -s -X POST --data-binary @img.jpg localhost:8000/segment?format=color > seg.png

Runs on the card unless ``--device cpu``. More than one card
(``--devices``) is ROADMAP item 11.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_backends(args, opts):
    """Returns (list of predict_batch backends, info dict, warmup thunk)."""
    if (getattr(args, "devices", 1) or 1) > 1:
        raise NotImplementedError("the port serves from one device (multi-GPU: ROADMAP item 11)")
    device = getattr(args, "device", "cuda")
    if args.bundle:
        if opts:
            raise SystemExit(
                f"cfg overrides {opts} have no effect with --bundle "
                "(the bundle is already an exported artifact)"
            )
        from semseg_tpu_torch.serving import Predictor

        backends = [Predictor(args.bundle, device=device)]
        info = {
            "backend": "bundle",
            "bundle": args.bundle,
            "devices": len(backends),
            "programs": sorted(f"{b}x{h}x{w}" for (b, h, w) in backends[0].programs),
        }

        def warmup():
            # One call per exported program: the first call of each sets
            # up its kernels, which would tax the first unlucky request.
            for be in backends:
                for (b, h, w) in be.programs:
                    be.predict_batch([np.zeros((h, w, 3), np.uint8)] * b)

        return backends, info, warmup

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines
    from semseg_tpu_torch.config import cfg as _default_cfg
    from semseg_tpu_torch.server import LivePredictor

    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if opts:
        cfg.merge_from_list(opts)
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)
    # batch > 1 selects BatchedInferenceEngine (LivePredictor requires its
    # batched_predict); pack_buckets folds under-filled request batches.
    engines = build_engines(cfg, 1, batch=max(2, args.max_batch), pack_buckets=True,
                            device=device)
    backends = [LivePredictor(cfg, e) for e in engines]
    info = {
        "backend": "live",
        "cfg": args.cfg,
        "arch": f"{cfg.MODEL.arch_encoder}+{cfg.MODEL.arch_decoder}",
        "devices": len(backends),
        "scales": list(cfg.DATASET.imgSizes),
    }

    def warmup():
        # The buckets of ONE representative shape (the canonical 2:3 val
        # image); other buckets set up lazily per request.
        for be in backends:
            be.predict_batch([np.zeros((512, 683, 3), np.uint8)])

    return backends, info, warmup


def build_server(argv=None):
    """The bound, warmed-up ``SegmentationServer`` that ``main`` serves
    from (its batcher at ``server.batcher``) and the backends behind it;
    the caller serves and closes it."""
    from semseg_tpu_torch.server import MicroBatcher, SegmentationServer
    from semseg_tpu_torch.utils import setup_logger

    p = argparse.ArgumentParser(description="semseg_tpu_torch serving endpoint")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", help="exported serving bundle directory")
    src.add_argument("--cfg", help="model config YAML (live TTA backend)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--devices", type=int, default=1,
                   help="serve from the first N cards (N > 1: ROADMAP item 11)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-batch", type=int, default=8, help="batch-size flush threshold")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="deadline flush: max added queueing latency")
    p.add_argument("--max-queue", type=int, default=128,
                   help="admission control: pending requests beyond this "
                        "are rejected with 503")
    p.add_argument("--request-timeout-s", type=float, default=300.0,
                   help="per-request prediction deadline (504 past it)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warm-up call of each program before binding")
    p.add_argument("--quiet", action="store_true", help="no access log")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="cfg overrides (live backend), e.g. TEST.checkpoint …")
    args = p.parse_args(argv)
    logger = setup_logger()
    backends, info, warmup = build_backends(args, args.opts)
    if not args.no_warmup:
        logger.info("warming up…")
        warmup()

    batcher = MicroBatcher(
        [b.predict_batch for b in backends],
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        # Live backend: pyramids build in the HTTP handler thread, ahead
        # of the batcher.
        preprocess=getattr(backends[0], "preprocess", None),
    )
    server = SegmentationServer(
        (args.host, args.port), batcher, info=info, quiet=args.quiet,
        request_timeout_s=args.request_timeout_s,
    )
    logger.info(
        f"serving {info['backend']} backend on {args.device} at "
        f"http://{args.host}:{server.server_address[1]} "
        f"(max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms})"
    )
    return server, backends


def main(argv=None):
    from semseg_tpu_torch.utils import setup_logger

    server, _ = build_server(argv)
    logger = setup_logger()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.server_close()
        server.batcher.close()


if __name__ == "__main__":
    main()
