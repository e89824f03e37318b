"""MPII PCKh evaluation.

The port's copy of `advmix_tpu/evaluation/mpii_eval.py` (reference
`MPIIDataset.evaluate`, `lib/dataset/mpii.py:114-202`): predictions turned
1-based and saved as pred.mat (`<corruption>_<severity>_pred.mat` under
TEST.TEST_ROBUST), PCKh@0.5 against `annot/gt_<set>.mat` head-box sizes
times SC_BIAS 0.6, pelvis and thorax masked, the per-part table and the
visibility-weighted Mean and Mean@0.1. Host numpy and scipy, as there.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
from scipy.io import loadmat, savemat

SC_BIAS = 0.6


def evaluate_mpii_pckh(cfg, dataset, preds, output_dir):
    """(name_values, Mean) of predictions (N, 16, >=2) in 0-based image
    coordinates, in the order of `annot/gt_<TEST_SET>.mat`."""
    preds = np.asarray(preds)[:, :, 0:2] + 1.0  # 0-based -> 1-based

    if output_dir:
        if cfg.TEST.TEST_ROBUST:
            pred_file = os.path.join(
                output_dir,
                f"{cfg.TEST.CORRUPTION_TYPE}_{cfg.TEST.SEVERITY}_pred.mat")
        else:
            pred_file = os.path.join(output_dir, "pred.mat")
        savemat(pred_file, mdict={"preds": preds})

    if "test" in cfg.DATASET.TEST_SET:
        return {"Null": 0.0}, 0.0

    gt_file = os.path.join(cfg.DATASET.ROOT, "annot",
                           f"gt_{cfg.DATASET.TEST_SET}.mat")
    gt = loadmat(gt_file)
    dataset_joints = gt["dataset_joints"]
    jnt_missing = gt["jnt_missing"]
    pos_gt_src = gt["pos_gt_src"]
    headboxes_src = gt["headboxes_src"]

    pos_pred_src = np.transpose(preds, [1, 2, 0])

    def jid(name):
        # loadmat gives an object array of 1-element arrays
        return np.where(dataset_joints == name)[1][0]

    jnt_visible = 1 - jnt_missing
    uv_err = np.linalg.norm(pos_pred_src - pos_gt_src, axis=1)
    headsizes = headboxes_src[1, :, :] - headboxes_src[0, :, :]
    headsizes = np.linalg.norm(headsizes, axis=0) * SC_BIAS
    scale = headsizes[None, :] * np.ones((len(uv_err), 1))
    scaled_err = (uv_err / scale) * jnt_visible
    jnt_count = np.sum(jnt_visible, axis=1)

    def pck_at(threshold):
        less = (scaled_err <= threshold) * jnt_visible
        return 100.0 * np.sum(less, axis=1) / jnt_count

    pckh = pck_at(0.5)
    pckh_01 = pck_at(0.11)  # rng[11] == 0.11 in the reference's arange

    # mask pelvis (6) and thorax (7)
    pckh_m = np.ma.array(pckh, mask=False)
    pckh_m.mask[6:8] = True
    jc = np.ma.array(jnt_count, mask=False)
    jc.mask[6:8] = True
    jnt_ratio = jc / np.sum(jc).astype(np.float64)

    name_value = OrderedDict([
        ("Head", float(pckh_m[jid("head")])),
        ("Shoulder", 0.5 * float(pckh_m[jid("lsho")] + pckh_m[jid("rsho")])),
        ("Elbow", 0.5 * float(pckh_m[jid("lelb")] + pckh_m[jid("relb")])),
        ("Wrist", 0.5 * float(pckh_m[jid("lwri")] + pckh_m[jid("rwri")])),
        ("Hip", 0.5 * float(pckh_m[jid("lhip")] + pckh_m[jid("rhip")])),
        ("Knee", 0.5 * float(pckh_m[jid("lkne")] + pckh_m[jid("rkne")])),
        ("Ankle", 0.5 * float(pckh_m[jid("lank")] + pckh_m[jid("rank")])),
        ("Mean", float(np.sum(pckh_m * jnt_ratio))),
        ("Mean@0.1", float(np.sum(pckh_01 * jnt_ratio))),
    ])
    return name_value, name_value["Mean"]
