from hierarchicalprobabilistic3dhuman_torch.metrics.eval_metrics_tracker import EvalMetricsTracker
from hierarchicalprobabilistic3dhuman_torch.metrics.train_loss_and_metrics_tracker import (
    TrainingLossesAndMetricsTracker)

__all__ = ["EvalMetricsTracker", "TrainingLossesAndMetricsTracker"]
