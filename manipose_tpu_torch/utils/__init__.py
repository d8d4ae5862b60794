"""Host-side helpers of the port."""

from .logging import AverageMeter, MetricLogger, save_csv_log

__all__ = ["AverageMeter", "MetricLogger", "save_csv_log"]
