"""Statistical significance testing for editing-method comparisons. Port of
``rgie_tpu/analysis/stats_tests.py``: the same tests on a table that is a
pandas ``DataFrame`` or a plain ``{column: array}`` dict (the path the
analysis CLIs drive needs no pandas).

Reference: ``src/analysis/statistical_analysis.py``: Shapiro normality gate
-> one-way ANOVA + Bonferroni post-hoc t-tests, or Kruskal-Wallis + Conover
post-hoc with Holm correction. statsmodels and scikit_posthocs are not
dependencies, so ANOVA, the pairwise t-tests, the Conover test, and the
Holm/Bonferroni corrections are implemented directly on scipy primitives
(same formulas).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import stats


def one_way_stats_test(df, iv: str, dv: str, verbose: bool = True) -> dict:
    """Shapiro gate then ANOVA or Kruskal (statistical_analysis.py:7-14)."""
    _, p_norm = stats.shapiro(column(df, dv))
    if p_norm < 0.05:
        return kruskal_wallis_test(df, iv, dv, verbose)
    return one_way_anova(df, iv, dv, verbose)


def column(df, name: str) -> np.ndarray:
    """One column of a DataFrame or of a ``{column: array}`` dict, as numpy."""
    values = df[name]
    return np.asarray(getattr(values, "values", values))


def levels(df, iv: str) -> list:
    """The distinct values of ``iv`` in their order of first appearance
    (pandas' ``unique``)."""
    seen = {}
    for v in column(df, iv).tolist():
        seen.setdefault(v, None)
    return list(seen)


def _groups(df, iv, dv) -> Dict[str, np.ndarray]:
    ivs, dvs = column(df, iv), column(df, dv)
    return {lvl: dvs[ivs == lvl].astype(np.float64) for lvl in levels(df, iv)}


def one_way_anova(df, iv: str, dv: str, verbose: bool = True) -> dict:
    groups = _groups(df, iv, dv)
    f_stat, p_value = stats.f_oneway(*groups.values())
    result = {"test": "anova", "statistic": float(f_stat), "p_value": float(p_value)}
    if verbose:
        print("\n" + dv)
        print(f"ANOVA F: {f_stat:.4f}  p: {p_value:.6f}")
        print_mean_sd(df, iv, dv)
    if p_value < 0.05:
        result["posthoc"] = posthoc_ttest(groups, p_adjust="bonferroni", verbose=verbose)
    return result


def kruskal_wallis_test(df, iv: str, dv: str, verbose: bool = True) -> dict:
    groups = _groups(df, iv, dv)
    statistic, p_value = stats.kruskal(*groups.values())
    result = {"test": "kruskal", "statistic": float(statistic), "p_value": float(p_value)}
    if verbose:
        print("\n" + dv)
        print(f"Kruskal-Wallis Test Statistic: {statistic}")
        print(f"P-value: {p_value}")
        print_mean_sd(df, iv, dv)
    if p_value < 0.05:
        result["posthoc"] = posthoc_conover(groups, p_adjust="holm", verbose=verbose)
    return result


def adjust_pvalues(pvals: Sequence[float], method: str) -> List[float]:
    """Bonferroni / Holm step-down corrections."""
    p = np.asarray(pvals, dtype=np.float64)
    m = len(p)
    if method == "bonferroni":
        return list(np.minimum(p * m, 1.0))
    if method == "holm":
        order = np.argsort(p)
        adj = np.empty(m)
        running = 0.0
        for rank, ix in enumerate(order):
            val = (m - rank) * p[ix]
            running = max(running, val)
            adj[ix] = min(running, 1.0)
        return list(adj)
    raise ValueError(method)


def posthoc_ttest(groups: Dict[str, np.ndarray], p_adjust: str = "bonferroni",
                  verbose: bool = True) -> Dict[Tuple[str, str], float]:
    """Pairwise Welch-free t-tests with correction (scikit_posthocs
    posthoc_ttest equivalent; statistical_analysis.py:36-40)."""
    pairs = list(itertools.combinations(groups.keys(), 2))
    raw = [stats.ttest_ind(groups[a], groups[b]).pvalue for a, b in pairs]
    adj = adjust_pvalues(raw, p_adjust)
    out = {pair: float(p) for pair, p in zip(pairs, adj)}
    if verbose:
        for (a, b), p in out.items():
            print(f"  t-test {a} vs {b}: p={p:.6f}")
    return out


def posthoc_conover(groups: Dict[str, np.ndarray], p_adjust: str = "holm",
                    verbose: bool = True) -> Dict[Tuple[str, str], float]:
    """Conover-Iman post-hoc after Kruskal-Wallis (scikit_posthocs
    posthoc_conover equivalent; statistical_analysis.py:57-60)."""
    names = list(groups.keys())
    data = np.concatenate([groups[n] for n in names])
    labels = np.concatenate([[n] * len(groups[n]) for n in names])
    n = len(data)
    k = len(names)
    ranks = stats.rankdata(data)
    rank_sums = {name: ranks[labels == name].sum() for name in names}
    sizes = {name: int((labels == name).sum()) for name in names}

    h_stat, _ = stats.kruskal(*groups.values())
    # tie correction
    _, counts = np.unique(data, return_counts=True)
    tie_corr = 1.0 - (counts ** 3 - counts).sum() / (n ** 3 - n)
    h_cor = h_stat / tie_corr if tie_corr > 0 else h_stat

    s2 = (np.sum(ranks ** 2) - n * ((n + 1.0) ** 2) / 4.0) / (n - 1.0)
    df = n - k

    pairs = list(itertools.combinations(names, 2))
    raw = []
    for a, b in pairs:
        diff = abs(rank_sums[a] / sizes[a] - rank_sums[b] / sizes[b])
        denom = np.sqrt(s2 * ((n - 1.0 - h_cor) / df) * (1.0 / sizes[a] + 1.0 / sizes[b]))
        t_val = diff / denom if denom > 0 else 0.0
        raw.append(2.0 * stats.t.sf(np.abs(t_val), df=df))
    adj = adjust_pvalues(raw, p_adjust)
    out = {pair: float(p) for pair, p in zip(pairs, adj)}
    if verbose:
        print("Post-Hoc Test Results (Conover/%s):" % p_adjust)
        for (a, b), p in out.items():
            print(f"  {a} vs {b}: p={p:.6f}")
    return out


def print_mean_sd(df, iv: str, dv: str) -> None:
    """(statistical_analysis.py:63-69)"""
    print()
    for lvl, values in _groups(df, iv, dv).items():
        sd = values.std(ddof=1) if len(values) > 1 else float("nan")
        print(f"{lvl} M:{values.mean():.2f} SD:{sd:.2f}")
    print()
