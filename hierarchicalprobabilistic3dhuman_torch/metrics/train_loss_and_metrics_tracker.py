"""Training loss/metrics tracker with a log.pkl-compatible history.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/metrics/
train_loss_and_metrics_tracker.py, line for line: per-epoch train/val loss
means plus 10 metric families, resume-aware history loading with zero-fill
for missing metrics, and best-model selection requiring ALL save metrics to
improve. log.pkl holds the same keys. The host path (update_per_batch)
takes numpy arrays and runs the alignments through the port's torch
functions on the CPU; update_per_batch_sums takes the scalars of
metrics/metric_sums.py::make_metric_sums_fn.
"""

import pickle

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.utils.eval_utils import (
    procrustes_analysis_batch, scale_and_translation_transform_batch)
from hierarchicalprobabilistic3dhuman_torch.utils.joints2d_utils import (
    undo_keypoint_normalisation)

ALL_METRICS_TYPES = ['train_PVE', 'val_PVE',
                     'train_PVE-SC', 'val_PVE-SC',
                     'train_PVE-PA', 'val_PVE-PA',
                     'train_PVE-T', 'val_PVE-T',
                     'train_PVE-T-SC', 'val_PVE-T-SC',
                     'train_MPJPE', 'val_MPJPE',
                     'train_MPJPE-SC', 'val_MPJPE-SC',
                     'train_MPJPE-PA', 'val_MPJPE-PA',
                     'train_joints2D-L2E', 'val_joints2D-L2E',
                     'train_joints2Dsamples-L2E', 'val_joints2Dsamples-L2E']


def _np_align(fn, p, t):
    """An alignment of the port's (torch) on numpy arrays."""
    return fn(torch.from_numpy(np.ascontiguousarray(p, np.float32)),
              torch.from_numpy(np.ascontiguousarray(t, np.float32))).numpy()


class TrainingLossesAndMetricsTracker:
    def __init__(self, metrics_to_track, img_wh, log_save_path,
                 load_logs=False, current_epoch=None):
        self.all_metrics_types = ALL_METRICS_TYPES
        self.metrics_to_track = metrics_to_track
        self.img_wh = img_wh
        self.log_save_path = log_save_path

        if load_logs:
            self.epochs_history = self.load_history(log_save_path, current_epoch)
        else:
            self.epochs_history = {'train_losses': [], 'val_losses': []}
            for metric_type in self.all_metrics_types:
                self.epochs_history[metric_type] = []
        self.loss_metric_sums = None

    def load_history(self, load_log_path, current_epoch):
        """Resume: truncate to the current epoch; zero-fill missing metrics."""
        with open(load_log_path, 'rb') as f:
            history = pickle.load(f)
        history['train_losses'] = history['train_losses'][:current_epoch]
        history['val_losses'] = history['val_losses'][:current_epoch]
        for metric_type in self.all_metrics_types:
            if metric_type in history:
                history[metric_type] = history[metric_type][:current_epoch]
            else:
                history[metric_type] = [0.0] * current_epoch
                print(metric_type, 'filled with zeros up to epoch', current_epoch)
        for key in history:
            if len(history[key]) != current_epoch:
                raise ValueError(f"{len(history[key])} elements in {key} list "
                                 f"when current epoch is {current_epoch}")
        print('Logs loaded from', load_log_path)
        return history

    def initialise_loss_metric_sums(self):
        self.loss_metric_sums = {'train_losses': 0., 'val_losses': 0.,
                                 'train_num_samples': 0, 'val_num_samples': 0}
        for metric_type in self.all_metrics_types:
            self.loss_metric_sums[metric_type] = 0.
        self.loss_metric_sums['train_num_visib_joints2Dsamples'] = 0.
        self.loss_metric_sums['val_num_visib_joints2Dsamples'] = 0.

    def update_per_batch(self, split, loss, pred_dict, target_dict, batch_size,
                         pred_reposed_vertices=None, target_reposed_vertices=None):
        """Accumulate one batch's sums from host arrays."""
        assert split in ('train', 'val')
        pred = {k: np.asarray(v) for k, v in pred_dict.items()}
        target = {k: np.asarray(v) for k, v in target_dict.items()}
        if any('PVE-T' in m for m in self.metrics_to_track):
            if pred_reposed_vertices is None or target_reposed_vertices is None:
                raise ValueError("PVE-T metrics need the reposed vertices")
            pred_reposed_vertices = np.asarray(pred_reposed_vertices)
            target_reposed_vertices = np.asarray(target_reposed_vertices)

        self.loss_metric_sums[split + '_losses'] += float(loss) * batch_size
        self.loss_metric_sums[split + '_num_samples'] += batch_size

        def add(name, value):
            self.loss_metric_sums[split + '_' + name] += float(value)

        if 'PVE' in self.metrics_to_track:
            add('PVE', np.sum(np.linalg.norm(pred['verts'] - target['verts'], axis=-1)))
        if 'PVE-SC' in self.metrics_to_track:
            p = pred['verts'].reshape(-1, 6890, 3)
            t = target['verts'].reshape(-1, 6890, 3)
            p_sc = _np_align(scale_and_translation_transform_batch, p, t)
            add('PVE-SC', np.sum(np.linalg.norm(p_sc - t, axis=-1)))
        if 'PVE-PA' in self.metrics_to_track:
            p = pred['verts'].reshape(-1, 6890, 3)
            t = target['verts'].reshape(-1, 6890, 3)
            p_pa = _np_align(procrustes_analysis_batch, p, t)
            add('PVE-PA', np.sum(np.linalg.norm(p_pa - t, axis=-1)))
        if 'PVE-T' in self.metrics_to_track:
            add('PVE-T', np.sum(np.linalg.norm(
                pred_reposed_vertices - target_reposed_vertices, axis=-1)))
        if 'PVE-T-SC' in self.metrics_to_track:
            p_sc = _np_align(scale_and_translation_transform_batch,
                             pred_reposed_vertices, target_reposed_vertices)
            add('PVE-T-SC', np.sum(np.linalg.norm(p_sc - target_reposed_vertices, axis=-1)))
        if 'MPJPE' in self.metrics_to_track:
            add('MPJPE', np.sum(np.linalg.norm(pred['joints3D'] - target['joints3D'], axis=-1)))
        if 'MPJPE-SC' in self.metrics_to_track:
            p = pred['joints3D'].reshape(-1, 14, 3)
            t = target['joints3D'].reshape(-1, 14, 3)
            p_sc = _np_align(scale_and_translation_transform_batch, p, t)
            add('MPJPE-SC', np.sum(np.linalg.norm(p_sc - t, axis=-1)))
        if 'MPJPE-PA' in self.metrics_to_track:
            p = pred['joints3D'].reshape(-1, 14, 3)
            t = target['joints3D'].reshape(-1, 14, 3)
            p_pa = _np_align(procrustes_analysis_batch, p, t)
            add('MPJPE-PA', np.sum(np.linalg.norm(p_pa - t, axis=-1)))
        if 'joints2D-L2E' in self.metrics_to_track:
            p2d = undo_keypoint_normalisation(pred['joints2D'], self.img_wh)
            add('joints2D-L2E', np.sum(np.linalg.norm(p2d - target['joints2D'], axis=-1)))
        if 'joints2Dsamples-L2E' in self.metrics_to_track:
            p = pred['joints2Dsamples']                                  # (B, N, 17, 2)
            t = np.repeat(target['joints2D'][:, None], p.shape[1], axis=1)
            vis = np.repeat(np.asarray(target['joints2D_vis'])[:, None], p.shape[1], axis=1)
            p = undo_keypoint_normalisation(p[vis], self.img_wh)
            err = np.linalg.norm(p - t[vis], axis=-1)
            add('joints2Dsamples-L2E', np.sum(err))
            self.loss_metric_sums[split + '_num_visib_joints2Dsamples'] += err.shape[0]

    def update_per_batch_sums(self, split, loss, batch_size, metric_sums):
        """Accumulate the metric sums the train step computed where its
        tensors are: the host sees scalars only."""
        assert split in ('train', 'val')
        self.loss_metric_sums[split + '_losses'] += float(loss) * batch_size
        self.loss_metric_sums[split + '_num_samples'] += batch_size
        for name, value in metric_sums.items():
            self.loss_metric_sums[split + '_' + name] += float(value)

    def update_per_epoch(self):
        self.epochs_history['train_losses'].append(
            self.loss_metric_sums['train_losses'] / self.loss_metric_sums['train_num_samples'])
        self.epochs_history['val_losses'].append(
            self.loss_metric_sums['val_losses'] / self.loss_metric_sums['val_num_samples'])

        for metric_type in self.all_metrics_types:
            split = metric_type.split('_')[0]
            base = metric_type[metric_type.find('_') + 1:]
            if base in self.metrics_to_track:
                if 'joints2Dsamples' in metric_type:
                    val = (self.loss_metric_sums[split + '_joints2Dsamples-L2E']
                           / max(self.loss_metric_sums[split + '_num_visib_joints2Dsamples'], 1))
                else:
                    if 'PVE' in metric_type:
                        num_per_sample = 6890
                    elif 'MPJPE' in metric_type:
                        num_per_sample = 14
                    else:
                        num_per_sample = 17
                    val = self.loss_metric_sums[metric_type] / (
                        self.loss_metric_sums[split + '_num_samples'] * num_per_sample)
                self.epochs_history[metric_type].append(val)
            else:
                self.epochs_history[metric_type].append(0.)

        print('Finished epoch.')
        print('Train Loss: {:.5f}, Val Loss: {:.5f}'.format(
            self.epochs_history['train_losses'][-1],
            self.epochs_history['val_losses'][-1]))
        for metric in self.metrics_to_track:
            print('Train {}: {:.5f}, Val {}: {:.5f}'.format(
                metric, self.epochs_history['train_' + metric][-1],
                metric, self.epochs_history['val_' + metric][-1]))

        if self.log_save_path is not None:
            with open(self.log_save_path, 'wb') as f:
                pickle.dump(self.epochs_history, f)

    def determine_save_model_weights_this_epoch(self, save_val_metrics,
                                                best_epoch_val_metrics):
        """Save only when ALL save metrics improved."""
        for metric in save_val_metrics:
            if self.epochs_history['val_' + metric][-1] > best_epoch_val_metrics[metric]:
                return False
        return True
