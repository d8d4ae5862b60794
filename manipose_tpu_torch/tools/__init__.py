"""Command-line tools of the port, each run as ``python -m
manipose_tpu_torch.tools.<name>``: the FK-synthetic dataset generators
(``make_synthetic_3dhp``, ``make_synthetic_h36m``, on ``synthetic_overfit``'s
pose videos), the streaming-accuracy study (``streaming_eval``), and the
serving tools: the HTTP server (``serve``), the batch CLI (``predict``) and
the ``torch.export`` artifact writer (``export_model``)."""
