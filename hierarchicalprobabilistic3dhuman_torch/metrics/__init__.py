from hierarchicalprobabilistic3dhuman_torch.metrics.eval_metrics_tracker import EvalMetricsTracker

__all__ = ["EvalMetricsTracker"]
