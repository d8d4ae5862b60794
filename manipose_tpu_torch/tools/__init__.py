"""Command-line tools of the port, each run as ``python -m
manipose_tpu_torch.tools.<name>``: the FK-synthetic dataset generators
(``make_synthetic_3dhp``, ``make_synthetic_h36m``, on ``synthetic_overfit``'s
pose videos), the streaming-accuracy study (``streaming_eval``), the
serving tools (the HTTP server ``serve``, the batch CLI ``predict``, the
``torch.export`` artifact writer ``export_model``), the side-by-side
renderer ``viz``, the tools that run the model: ``count_n_params``,
``bench_eval``, ``bench_sustained``, ``synthetic_overfit`` (learning
validation), ``robustness_sweep``, ``step_ablation`` and ``hp_search``, the
offline-analysis tools ``eval_baselines``, ``get_table_data`` and
``plot_analysis``, the muP tools ``mup_coord_check`` and ``mup_lr_transfer``,
the segments-head A/B ``seg_heads_ab`` and the toy Table 1/6 runs
``quantitative_comparison``."""
