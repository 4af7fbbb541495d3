"""Project paths and the eval file-name contracts (the port's copy of
``rcu_tpu/directories.py``; the analysis layer keys on these names, so
they never change).

Deployment-specific locations are the ``_RUNS`` slots and the raw data
dirs below; set them by editing this file or by assigning the module
attributes before use (the tests and ``chip_smoke.py`` do the latter).
"""
import os

PROJECT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _p(*parts):
    return os.path.join(PROJECT_DIR, *parts)


# -- deployment slots: filled per environment ------------------------------
# raw dataset downloads
BRATS_ORIG_DATA_DIR = ""   # e.g. <path>/Brats18/Training
ISIC_ORIG_DATA_DIR = ""    # e.g. <path>/isic2017-melanoma

# per-strategy prediction run dirs (basename of the test run dir under the
# dataset's prediction dir), one slot per strategy id
_RUNS = {
    "BRATS": dict(BASELINE="", BASELINE_MC="", CENTER="", CENTER_MC="",
                  ENSEMBLE="", AUX_FEAT="", AUX_SEGM="", ALEATORIC="", CV=""),
    "ISIC": dict(BASELINE="", BASELINE_MC="", CENTER="", CENTER_MC="",
                 ENSEMBLE="", AUX_FEAT="", AUX_SEGM="", ALEATORIC=""),
}
for _ds, _slots in _RUNS.items():
    for _key, _value in _slots.items():
        globals()[f"{_ds}_{_key}_PREDICT"] = _value

# -- derived locations ------------------------------------------------------
CONFIG_DIR = _p("config")
SPLITS_DIR = _p("config", "splits")
DATASET_DIR = _p("in", "datasets")

ISIC_PREPROCESSED_DIR = os.path.join(DATASET_DIR, "isic_small")
ISIC_PREPROCESSED_TRAIN_DATA_DIR = os.path.join(ISIC_PREPROCESSED_DIR,
                                                "ISIC-2017_Training")
ISIC_PREPROCESSED_TEST_DATA_DIR = os.path.join(ISIC_PREPROCESSED_DIR,
                                               "ISIC-2017_Test_v2")

ISIC_ORIG_TRAIN_DATA_DIR = os.path.join(ISIC_ORIG_DATA_DIR, "ISIC-2017_Training")
ISIC_ORIG_VALID_DATA_DIR = os.path.join(ISIC_ORIG_DATA_DIR, "ISIC-2017_Validation")
ISIC_ORIG_TEST_DATA_DIR = os.path.join(ISIC_ORIG_DATA_DIR, "ISIC-2017_Test_v2")

PREDICT_DIR = _p("out", "predictions")
ISIC_PREDICT_DIR = os.path.join(PREDICT_DIR, "isic")
BRATS_PREDICT_DIR = os.path.join(PREDICT_DIR, "brats")

EVAL_DIR = _p("out", "eval")
ISIC_EVAL_DIR = os.path.join(EVAL_DIR, "isic")
BRATS_EVAL_DIR = os.path.join(EVAL_DIR, "brats")

PLOT_DIR = _p("out", "plots")
ISIC_PLOT_DIR = os.path.join(PLOT_DIR, "isic")
BRATS_PLOT_DIR = os.path.join(PLOT_DIR, "brats")

# -- evaluation/analysis contracts (never change: analysis keys on these) ----
ECE_FOREGROUND_NAME = "ece_foreground"
ECE_NAME = "ece"
CALIB_NAME = "calibration"
UNCERTAINTY_NAME = "uncertainty"
MINMAX_NAME = "minmax"

CALIBRATION_PLACEHOLDER = "eval_calibration_{}.csv"
UNCERTAINTY_PLACEHOLDER = "eval_uncertainty_{}_th{}.csv"
ECE_PLACEHOLDER = "eval_ece_{}.csv"
MINMAX_PLACEHOLDER = "eval_summary_minmax_{}.csv"
