"""Command-line tools of the port, each run as ``python -m
manipose_tpu_torch.tools.<name>``: the FK-synthetic dataset generators
(``make_synthetic_3dhp``, ``make_synthetic_h36m``, on ``synthetic_overfit``'s
pose videos) and the streaming-accuracy study (``streaming_eval``)."""
