"""Two-model significance testing — a copy of
heart_murmur_detection_tpu/analysis/significance.py (`test_2models` :11;
the reference's src/benchmark/significance_test.py:178-216): an unpaired
two-sample t-test over the per-seed scores of two models."""

from __future__ import annotations

from typing import Sequence, Tuple

from scipy.stats import ttest_ind


def test_2models(
    scores_1: Sequence[float], scores_2: Sequence[float], alpha: float = 0.01
) -> Tuple[float, float, bool]:
    """Returns (t_stat, p_value, reject_null)."""
    t_stat, p_val = ttest_ind(list(scores_1), list(scores_2))
    reject = p_val <= alpha
    if reject:
        print(f"<= {alpha} ", "Reject null hypothesis")
    else:
        print(f"> {alpha} ", "Fail to reject null hypothesis")
    return float(t_stat), float(p_val), bool(reject)
