"""Eval CSV file-name contracts (copy of ``rcu_tpu/directories.py``'s; the
analysis layer keys on these names, so they never change) and the shipped
config directory."""
import os

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")

CALIBRATION_PLACEHOLDER = "eval_calibration_{}.csv"
UNCERTAINTY_PLACEHOLDER = "eval_uncertainty_{}_th{}.csv"
ECE_PLACEHOLDER = "eval_ece_{}.csv"
MINMAX_PLACEHOLDER = "eval_summary_minmax_{}.csv"
