"""Eval/inference throughput of the serving Predictor on the card.

The port's copy of ``tools/bench_eval.py``: ``Predictor.predict_video``'s
end-to-end rate (windowing, the batched forward with TTA, aggregation) in
frames/s on the flagship rMCL model of ``configs/config.yaml``: 16 windows
of ``data.seq_len`` frames in batches of 16, one warm run, then the mean
of 5 timed runs.

  python -m manipose_tpu_torch.tools.bench_eval [--int8] [overrides...]

``--int8`` asks for int8 serving (``Predictor(quantize=True)``), which
stays on the float path, with a warning, where int8 GEMMs are not faster
than bf16. Overrides are config overrides: ``model.dtype=bfloat16`` for
bf16 compute, ``device=cpu`` for the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_WINDOWS = 16
N_RUNS = 5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..serving import Predictor

    cfg = load_config("config", args.overrides)
    predictor = Predictor(cfg=cfg, batch_size=16, tta=True, quantize=args.int8,
                          device=cfg.get("device", "cuda"))
    rng = np.random.default_rng(0)
    video = rng.normal(size=(N_WINDOWS * cfg.data.seq_len, 17, 2)).astype(np.float32)

    predictor.predict_video(video)  # warm
    t0 = time.perf_counter()
    for _ in range(N_RUNS):
        predictor.predict_video(video)
    # predict_video returns host arrays: the device work has finished
    dt = (time.perf_counter() - t0) / N_RUNS
    record = {
        "metric": "rmcl_manipose_243f_eval_throughput"
                  + ("_int8" if args.int8 else ""),
        "value": round(video.shape[0] / dt, 1),
        "unit": "frames/s",
        "tta": True,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
