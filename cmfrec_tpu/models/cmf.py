"""CMF and CMF_implicit — the flagship model classes.

API-compatible with the reference's classes of the same names
(/root/reference/cmfrec/__init__.py:2446 CMF, :4358 CMF_implicit): same
constructor hyperparameters, same fitted attributes, same
fit/predict/topN/factors_warm/factors_cold surface.  The fitting engine is
the JAX ALS driver (solvers/drivers.py, solvers/collective.py) rather than
the reference's OpenMP C core.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import resolve_dtype
from ..solvers import drivers
from ..solvers.warm import factors_explicit_batch, factors_implicit_batch
from .base import _BaseModel


def _route_grouped(rows, m_new, min_rows=256, max_waste=3.0):
    """Serving-batch routing: use the degree-grouped warm path when
    padding every row to the batch max degree would waste > max_waste x
    the entry count (power-law request batches).  Small or uniform
    batches keep the plain padded path and its full-observation caches."""
    if m_new < min_rows:
        return False
    counts = np.bincount(rows, minlength=m_new)
    waste = m_new * int(counts.max(initial=0)) / max(rows.size, 1)
    return waste > max_waste


def _check_lambda(lambda_, name="lambda_"):
    arr = np.atleast_1d(np.asarray(lambda_, np.float64))
    if arr.size not in (1, 6):
        raise ValueError(f"'{name}' must be a scalar or an array of size 6")
    if np.any(arr < 0):
        raise ValueError(f"'{name}' must be non-negative")


def _validate_cmf_params(self, implicit=False):
    """Unsupported-combination checks matching the reference's _take_params
    (/root/reference/cmfrec/__init__.py:63-262)."""
    import warnings

    if getattr(self, "method", "als") not in ("als", "lbfgs"):
        raise ValueError("'method' must be one of 'als' or 'lbfgs'")
    if int(self.k) <= 0 and not (self.k_user and self.k_item):
        raise ValueError("'k' must be a positive integer")
    for nm in ("k_user", "k_item", "k_main"):
        if int(getattr(self, nm, 0)) < 0:
            raise ValueError(f"'{nm}' must be non-negative")
    _check_lambda(self.lambda_)
    _check_lambda(getattr(self, "l1_lambda", 0.0), "l1_lambda")
    if int(self.niter) < 0:
        raise ValueError("'niter' must be non-negative")
    if getattr(self, "method", "als") == "lbfgs":
        if (getattr(self, "NA_as_zero", False)
                or getattr(self, "NA_as_zero_user", False)
                or getattr(self, "NA_as_zero_item", False)):
            raise ValueError(
                "Option 'NA_as_zero' not supported with method='lbfgs'."
            )
        if getattr(self, "add_implicit_features", False):
            raise ValueError(
                "Option 'add_implicit_features' not supported with "
                "method='lbfgs'."
            )
        if (getattr(self, "nonneg", False) or getattr(self, "nonneg_C", False)
                or getattr(self, "nonneg_D", False)):
            raise ValueError(
                "non-negativity constraints not supported with "
                "method='lbfgs'."
            )
        if (getattr(self, "scale_lam", False)
                or getattr(self, "scale_lam_sideinfo", False)):
            raise ValueError("'scale_lam' not supported with method='lbfgs'.")
        if np.any(np.atleast_1d(np.asarray(
                getattr(self, "l1_lambda", 0.0), np.float64)) != 0.0):
            raise ValueError(
                "L1 regularization not supported with method='lbfgs'."
            )
    else:
        if int(getattr(self, "max_cg_steps", 3)) <= 0:
            raise ValueError("'max_cg_steps' must be a positive integer")
    if implicit and float(getattr(self, "alpha", 1.0)) <= 0:
        raise ValueError("'alpha' must be positive")
    if getattr(self, "center", False) and getattr(self, "nonneg", False):
        warnings.warn(
            "Warning: will fit a model with centering and non-negativity "
            "constraints."
        )


class CMF(_BaseModel):
    """Collective matrix factorization with explicit feedback.

    Model: X ~ A B^T (+ biases + mean), U ~ A C^T, I ~ B D^T
    (/root/reference/cmfrec/__init__.py:2446-2881).
    """

    _unknown_pred_mean = True  # unknown ids -> mean+biases (reference note)
    _supports_extra_side_rows = True  # m_u > m via the collective drivers

    def __init__(self, k=40, lambda_=1e1, method="als", use_cg=True,
                 user_bias=True, item_bias=True, center=True,
                 add_implicit_features=False,
                 scale_lam=False, scale_lam_sideinfo=False,
                 scale_bias_const=False,
                 k_user=0, k_item=0, k_main=0,
                 w_main=1.0, w_user=1.0, w_item=1.0, w_implicit=0.5,
                 l1_lambda=0.0, center_U=True, center_I=True,
                 maxiter=800, niter=10, parallelize="separate", corr_pairs=4,
                 max_cg_steps=3, precondition_cg=False, finalize_chol=True,
                 NA_as_zero=False, NA_as_zero_user=False, NA_as_zero_item=False,
                 nonneg=False, nonneg_C=False, nonneg_D=False, max_cd_steps=100,
                 precompute_for_predictions=True, include_all_X=True,
                 use_float=True,
                 random_state=1, verbose=False, print_every=10,
                 handle_interrupt=True, produce_dicts=False,
                 nthreads=-1, n_jobs=None,
                 checkpoint_path=None, checkpoint_every=0):
        self.k = k
        self.lambda_ = lambda_
        # cmfrec_tpu extension: mid-fit periodic checkpoints (ALS only;
        # utils/checkpoint.py — resume via the drivers' init=)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.method = method
        self.use_cg = use_cg
        self.user_bias = user_bias
        self.item_bias = item_bias
        self.center = center
        self.add_implicit_features = add_implicit_features
        self.scale_lam = scale_lam
        # the reference's Python class couples the flags: scale_lam
        # implies scale_lam_sideinfo (/root/reference/cmfrec/__init__.py:208)
        self.scale_lam_sideinfo = bool(scale_lam_sideinfo) or bool(scale_lam)
        self.scale_bias_const = scale_bias_const
        self.k_user = k_user
        self.k_item = k_item
        self.k_main = k_main
        self.w_main = w_main
        self.w_user = w_user
        self.w_item = w_item
        self.w_implicit = w_implicit
        self.l1_lambda = l1_lambda
        self.center_U = center_U
        self.center_I = center_I
        self.maxiter = maxiter
        self.niter = niter
        self.parallelize = parallelize
        self.corr_pairs = corr_pairs
        self.max_cg_steps = max_cg_steps
        self.precondition_cg = precondition_cg
        self.finalize_chol = finalize_chol
        self.NA_as_zero = NA_as_zero
        self.NA_as_zero_user = NA_as_zero_user
        self.NA_as_zero_item = NA_as_zero_item
        self.nonneg = nonneg
        self.nonneg_C = nonneg_C
        self.nonneg_D = nonneg_D
        self.max_cd_steps = max_cd_steps
        self.precompute_for_predictions = precompute_for_predictions
        self.include_all_X = include_all_X
        self.use_float = use_float
        self.random_state = random_state
        self.verbose = verbose
        self.print_every = print_every
        self.handle_interrupt = handle_interrupt
        self.produce_dicts = produce_dicts
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.is_fitted_ = False
        _validate_cmf_params(self)

    # ------------------------------------------------------------------ #

    def fit(self, X, U=None, I=None, U_bin=None, I_bin=None, W=None,
            mesh=None):
        """Fit to explicit-feedback data (reference:
        /root/reference/cmfrec/__init__.py:3066).  ``mesh`` (a
        jax.sharding.Mesh, e.g. from parallel.mesh.init_distributed) runs
        the ALS iterations row-sharded over the device mesh."""
        _validate_cmf_params(self)  # set_params may have changed options
        from ..config import set_handle_interrupt

        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, wgt, m, n = self._ingest_X(X, W)
        if self.scale_lam and self.scale_bias_const:
            # the constant bias-penalty scaling = mean observation weight
            # per row/column (common.c:3787 wsum/m); warm-factor solves
            # need it to hold the bias coordinate's penalty constant.
            # Collective fits overwrite these below with the
            # side-count-inclusive values they computed (collective.c:8070)
            wsum = (float(len(vals)) if wgt is None
                    else float(np.sum(wgt)))
            self.scaling_biasA_ = wsum / max(m, 1)
            self.scaling_biasB_ = wsum / max(n, 1)
        if (U_bin is not None or I_bin is not None) and self.method != "lbfgs":
            raise ValueError("Binary side info requires method='lbfgs'")
        if self.method == "lbfgs":
            return self._fit_lbfgs(rows, cols, vals, wgt, m, n, U, I,
                                   U_bin, I_bin, mesh=mesh)

        if U is None and I is None and not self.add_implicit_features \
                and self.k_user == 0 and self.k_item == 0 and self.k_main == 0:
            res = drivers.fit_explicit_als(
                rows, cols, vals, m, n, mesh=mesh,
                k=self.k, lambda_=self.lambda_, l1_lambda=self.l1_lambda,
                niter=self.niter, use_cg=self.use_cg,
                max_cg_steps=self.max_cg_steps,
                precondition_cg=self.precondition_cg,
                finalize_chol=self.finalize_chol,
                user_bias=self.user_bias, item_bias=self.item_bias,
                center=self.center, scale_lam=self.scale_lam,
                scale_bias_const=self.scale_bias_const,
                NA_as_zero=self.NA_as_zero, nonneg=self.nonneg,
                max_cd_steps=self.max_cd_steps, weights=wgt,
                dtype=self.dtype_, seed=self.random_state,
                verbose=self.verbose,
                checkpoint_path=self.checkpoint_path,
                checkpoint_every=self.checkpoint_every,
            )
        else:
            from ..solvers.collective import fit_collective_explicit_als

            side_U = self._ingest_side(U, self.user_mapping_, m, "U")
            side_I = self._ingest_side(I, self.item_mapping_, n, "I")
            res = fit_collective_explicit_als(
                rows, cols, vals, m, n, mesh=mesh,
                side_U=side_U, side_I=side_I,
                k=self.k, k_user=self.k_user, k_item=self.k_item,
                k_main=self.k_main,
                lambda_=self.lambda_, l1_lambda=self.l1_lambda,
                w_main=self.w_main, w_user=self.w_user, w_item=self.w_item,
                w_implicit=self.w_implicit,
                add_implicit_features=self.add_implicit_features,
                niter=self.niter, use_cg=self.use_cg,
                max_cg_steps=self.max_cg_steps,
                precondition_cg=self.precondition_cg,
                finalize_chol=self.finalize_chol,
                user_bias=self.user_bias, item_bias=self.item_bias,
                center=self.center, center_U=self.center_U,
                center_I=self.center_I,
                scale_lam=self.scale_lam,
                scale_lam_sideinfo=self.scale_lam_sideinfo,
                scale_bias_const=self.scale_bias_const,
                NA_as_zero=self.NA_as_zero,
                NA_as_zero_user=self.NA_as_zero_user,
                NA_as_zero_item=self.NA_as_zero_item,
                nonneg=self.nonneg, nonneg_C=self.nonneg_C,
                nonneg_D=self.nonneg_D, max_cd_steps=self.max_cd_steps,
                weights=wgt, dtype=self.dtype_, seed=self.random_state,
                verbose=self.verbose,
                checkpoint_path=self.checkpoint_path,
                checkpoint_every=self.checkpoint_every,
            )
            self.C_ = res.get("C")
            self.D_ = res.get("D")
            self.Ai_ = res.get("Ai")
            self.Bi_ = res.get("Bi")
            self.U_colmeans_ = res.get("U_colmeans")
            self.I_colmeans_ = res.get("I_colmeans")

        self.A_ = res["A"]
        self.B_ = res["B"]
        self.user_bias_ = res["biasA"]
        self.item_bias_ = res["biasB"]
        self.glob_mean_ = res["glob_mean"]
        if res.get("scaling_biasA") is not None:
            self.scaling_biasA_ = float(res["scaling_biasA"])
        if res.get("scaling_biasB") is not None:
            self.scaling_biasB_ = float(res["scaling_biasB"])
        self.is_fitted_ = True
        self.niter_ = self.niter
        self._build_dicts()
        if self.precompute_for_predictions:
            self.force_precompute_for_predictions()
        return self

    def _fit_lbfgs(self, rows, cols, vals, wgt, m, n, U, I, U_bin, I_bin,
                   mesh=None):
        from ..solvers.lbfgs import fit_collective_explicit_lbfgs

        side_U = self._ingest_side(U, self.user_mapping_, m, "U")
        side_I = self._ingest_side(I, self.item_mapping_, n, "I")
        side_Ub = self._ingest_side(U_bin, self.user_mapping_, m, "U")
        side_Ib = self._ingest_side(I_bin, self.item_mapping_, n, "I")
        res = fit_collective_explicit_lbfgs(
            rows, cols, vals, m, n,
            side_U=side_U, side_I=side_I, side_Ub=side_Ub, side_Ib=side_Ib,
            k=self.k, k_user=self.k_user, k_item=self.k_item,
            k_main=self.k_main,
            lambda_=self.lambda_,
            w_main=self.w_main, w_user=self.w_user, w_item=self.w_item,
            user_bias=self.user_bias, item_bias=self.item_bias,
            center=self.center, center_U=self.center_U, center_I=self.center_I,
            maxiter=self.maxiter, corr_pairs=self.corr_pairs,
            weights=wgt, dtype=self.dtype_, seed=self.random_state,
            verbose=self.verbose, print_every=self.print_every,
            mesh=mesh,
        )
        self.A_ = res["A"]
        self.B_ = res["B"]
        self.C_ = res.get("C")
        self.D_ = res.get("D")
        self.Cb_ = res.get("Cb")
        self.Db_ = res.get("Db")
        self.user_bias_ = res["biasA"]
        self.item_bias_ = res["biasB"]
        self.glob_mean_ = res["glob_mean"]
        self.U_colmeans_ = res.get("U_colmeans")
        self.I_colmeans_ = res.get("I_colmeans")
        self.nfev_ = res.get("nfev")
        self.niter_ = res.get("niter")
        self.is_fitted_ = True
        self._build_dicts()
        if self.precompute_for_predictions:
            self.force_precompute_for_predictions()
        return self

    # ------------------------------------------------------------------ #
    # warm / cold factors                                                 #
    # ------------------------------------------------------------------ #

    def factors_warm(self, X=None, X_col=None, X_val=None, W=None,
                     U=None, U_bin=None, U_col=None, U_val=None,
                     return_bias=False):
        """Latent factors for a new user given interactions (reference:
        /root/reference/cmfrec/__init__.py:3568).  With binary side info
        there is no closed form: runs the reference's per-row L-BFGS
        (collective_factors_lbfgs, /root/reference/src/collective.c:1146)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        cols, vals, wgt = self._new_row_X(X, X_col, X_val, W)
        if U_bin is not None:
            from ..solvers.warm import factors_bin_batch

            res = factors_bin_batch(
                self, cols[None, :], vals[None, :],
                None if wgt is None else wgt[None, :],
                np.array([len(cols)], np.int64),
                U=self._new_row_U(U, U_col, U_val),
                U_bin=np.asarray(U_bin, np.float64).reshape(1, -1),
                return_bias=True,
            )
            a, bias = res[0][0], float(res[1][0])
            return (a, bias) if return_bias else a
        a, bias = factors_explicit_batch(
            self, cols[None, :], vals[None, :],
            None if wgt is None else wgt[None, :],
            np.array([len(cols)], np.int64),
            U=self._new_row_U(U, U_col, U_val),
        )
        a, bias = a[0], float(bias[0])
        return (a, bias) if return_bias else a

    def factors_cold(self, U=None, U_bin=None, U_col=None, U_val=None):
        """Factors from side info only (reference:
        /root/reference/cmfrec/__init__.py:3398).  With binary side info
        routes through the per-row L-BFGS with k_main frozen at zero
        (/root/reference/src/collective.c:3412)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        if self.C_ is None and getattr(self, "Cb_", None) is None:
            raise ValueError("Model was fit without user side info")
        u_vec = self._new_row_U(U, U_col, U_val)
        if U_bin is not None:
            from ..solvers.warm import factors_bin_batch

            return factors_bin_batch(
                self, np.zeros((1, 0), np.int64), np.zeros((1, 0)),
                None, np.zeros(1, np.int64), U=u_vec,
                U_bin=np.asarray(U_bin, np.float64).reshape(1, -1),
                cold=True,
            )[0]
        a, _ = factors_explicit_batch(
            self, np.zeros((1, 0), np.int64), np.zeros((1, 0)),
            None, np.zeros(1, np.int64), U=u_vec,
        )
        return a[0]

    def _new_row_X(self, X, X_col, X_val, W):
        if X is not None:
            X = np.asarray(X, np.float64).ravel()
            cols = np.nonzero(~np.isnan(X))[0]
            vals = X[cols]
            wgt = None if W is None else np.asarray(W, np.float64).ravel()[cols]
        else:
            cols, _ = self._map_ids(np.asarray(X_col), self.item_mapping_, "item")
            cols = np.atleast_1d(cols)
            vals = np.asarray(X_val, np.float64).ravel()
            wgt = None if W is None else np.asarray(W, np.float64).ravel()
        return cols.astype(np.int64), vals, wgt

    def _new_row_U(self, U, U_col, U_val):
        if U is None and U_col is None:
            return None
        if U is not None:
            return np.asarray(U, np.float64).ravel()[None, :]
        p = self.C_.shape[0]
        u = np.full(p, np.nan)
        u[np.asarray(U_col, np.int64)] = np.asarray(U_val, np.float64)
        return u[None, :]

    def predict_warm(self, items, X=None, X_col=None, X_val=None, W=None,
                     U=None, U_bin=None, U_col=None, U_val=None):
        a, bias = self.factors_warm(
            X=X, X_col=X_col, X_val=X_val, W=W, U=U, U_bin=U_bin,
            U_col=U_col, U_val=U_val, return_bias=True,
        )
        i, _ = self._map_ids(items, self.item_mapping_, "item")
        i = np.atleast_1d(i)
        ku = self.k_user
        B = self._xB
        p = B[i] @ a[ku:] + self.glob_mean_ + bias
        if self.item_bias_ is not None:
            p = p + self.item_bias_[i]
        return p

    def topN_warm(self, n=10, X=None, X_col=None, X_val=None, W=None,
                  U=None, U_bin=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        a, bias = self.factors_warm(
            X=X, X_col=X_col, X_val=X_val, W=W, U=U, U_bin=U_bin,
            U_col=U_col, U_val=U_val, return_bias=True,
        )
        return self._topN_vec(a[self.k_user:], bias, n, include, exclude,
                              output_score)

    def topN_cold(self, n=10, U=None, U_bin=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        a = self.factors_cold(U=U, U_bin=U_bin, U_col=U_col, U_val=U_val)
        return self._topN_vec(a[self.k_user:], 0.0, n, include, exclude,
                              output_score)

    def predict_cold(self, items, U=None, U_bin=None, U_col=None, U_val=None):
        a = self.factors_cold(U=U, U_bin=U_bin, U_col=U_col, U_val=U_val)
        i, _ = self._map_ids(items, self.item_mapping_, "item")
        i = np.atleast_1d(i)
        p = self._xB[i] @ a[self.k_user:] + self.glob_mean_
        if self.item_bias_ is not None:
            p = p + self.item_bias_[i]
        return p

    def predict_cold_multiple(self, item, U=None, U_bin=None):
        """Predict for many (new user, existing item) pairs (reference:
        /root/reference/cmfrec/__init__.py:3291)."""
        R = np.asarray(U if U is not None else U_bin).shape[0]
        if U_bin is not None:
            from ..solvers.warm import factors_bin_batch

            a = factors_bin_batch(
                self, np.zeros((R, 0), np.int64), np.zeros((R, 0)), None,
                np.zeros(R, np.int64),
                U=None if U is None else np.asarray(U, np.float64),
                U_bin=np.asarray(U_bin, np.float64), cold=True,
            )
        else:
            U = np.asarray(U, np.float64)
            a, _ = factors_explicit_batch(
                self, np.zeros((U.shape[0], 0), np.int64),
                np.zeros((U.shape[0], 0)), None,
                np.zeros(U.shape[0], np.int64), U=U,
            )
        i, _ = self._map_ids(item, self.item_mapping_, "item")
        i = np.atleast_1d(i)
        p = np.sum(a[:, self.k_user:] * self._xB[i], axis=1) + self.glob_mean_
        if self.item_bias_ is not None:
            p = p + self.item_bias_[i]
        return p

    def item_factors_cold(self, I=None, I_bin=None, I_col=None, I_val=None):
        """Factors for a new item from its side info (reference:
        /root/reference/cmfrec/__init__.py:3434) — the swapped-role dual of
        factors_cold, solved against D."""
        if self.D_ is None and getattr(self, "Db_", None) is None:
            raise ValueError("Model was fit without item side info")
        return self.swap_users_and_items(precompute=False).factors_cold(
            U=I, U_bin=I_bin, U_col=I_col, U_val=I_val
        )

    def predict_new(self, user, I=None, I_bin=None):
        """Predict for (existing user, new item given side info) pairs
        (reference: /root/reference/cmfrec/__init__.py:3472)."""
        I = np.asarray(I, np.float64)
        if I.ndim == 1:
            I = I[None, :]
        sw = self.swap_users_and_items(precompute=False)
        b, _ = factors_explicit_batch(
            sw, np.zeros((I.shape[0], 0), np.int64),
            np.zeros((I.shape[0], 0)), None,
            np.zeros(I.shape[0], np.int64), U=I,
        )
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        u = np.atleast_1d(u)
        ki = self.k_item
        p = np.sum(self._xA[u] * b[:, ki:], axis=1) + self.glob_mean_
        if self.user_bias_ is not None:
            p = p + self.user_bias_[u]
        return p

    def topN_new(self, user, I=None, I_bin=None, n=10, output_score=False):
        """Rank a pool of NEW items (given their side info) for an existing
        user (reference: /root/reference/cmfrec/__init__.py:3511)."""
        I = np.asarray(I, np.float64)
        sw = self.swap_users_and_items(precompute=False)
        b, _ = factors_explicit_batch(
            sw, np.zeros((I.shape[0], 0), np.int64),
            np.zeros((I.shape[0], 0)), None,
            np.zeros(I.shape[0], np.int64), U=I,
        )
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        scores = b[:, self.k_item:] @ self._xA[int(u)] + self.glob_mean_
        if self.user_bias_ is not None:
            scores = scores + float(self.user_bias_[int(u)])
        n = min(n, scores.shape[0])
        idx = np.argpartition(-scores, n - 1)[:n]
        idx = idx[np.argsort(-scores[idx])]
        return (idx, scores[idx]) if output_score else idx

    def factors_multiple(self, X=None, U=None, U_bin=None, W=None,
                         return_bias=False):
        """Warm factors for many new users at once (reference:
        /root/reference/cmfrec/__init__.py:3706)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        if U_bin is not None:
            from ..solvers.warm import factors_bin_batch

            idx, vv, ww, counts = self._pack_new_rows(X, W, U)
            a, bias = factors_bin_batch(
                self, idx, vv, ww, counts,
                U=np.asarray(U, np.float64) if U is not None else None,
                U_bin=np.asarray(U_bin, np.float64), return_bias=True,
            )
            return (a, bias) if return_bias else a
        if X is not None:
            from ..solvers.warm import pack_padded_rows

            rows, cols, vals, wgt, m_new, _ = self._ingest_X_new(X, W)
            if _route_grouped(rows, m_new):
                # degree-grouped serving path: avoids padding every row
                # to the batch max degree (power-law batches waste
                # 10-30x otherwise); uniform batches keep the plain path
                # and its full-observation caches
                from ..solvers.warm import factors_explicit_grouped

                a, bias = factors_explicit_grouped(
                    self, rows, cols, vals, wgt, m_new,
                    U=np.asarray(U, np.float64) if U is not None else None,
                )
                return (a, bias) if return_bias else a
            idx, vv, ww, counts = pack_padded_rows(rows, cols, vals, wgt,
                                                   m_new)
        else:
            idx, vv, ww, counts = self._pack_new_rows(X, W, U)
        a, bias = factors_explicit_batch(
            self, idx, vv, ww, counts,
            U=np.asarray(U, np.float64) if U is not None else None,
        )
        return (a, bias) if return_bias else a

    def _pack_new_rows(self, X, W, U):
        """New-user interaction rows -> padded [R, L] idx/val/weight blocks."""
        if X is None:
            m_new = np.asarray(U).shape[0] if U is not None else 0
            return (np.zeros((m_new, 0), np.int64), np.zeros((m_new, 0)),
                    None, np.zeros(m_new, np.int64))
        from ..solvers.warm import pack_padded_rows

        rows, cols, vals, wgt, m_new, _ = self._ingest_X_new(X, W)
        return pack_padded_rows(rows, cols, vals, wgt, m_new)

    def predict_warm_multiple(self, X, item, W=None, U=None, U_bin=None):
        """Predict (new user row i, item[i]) for many new users at once
        (reference: /root/reference/cmfrec/__init__.py:3654)."""
        a, bias = self.factors_multiple(X=X, U=U, U_bin=U_bin, W=W,
                                        return_bias=True)
        i, _ = self._map_ids(item, self.item_mapping_, "item")
        i = np.atleast_1d(i)
        if i.shape[0] != a.shape[0]:
            raise ValueError("item must have one entry per row of X")
        p = np.sum(a[:, self.k_user:] * np.asarray(self._xB)[i], axis=1)
        p = p + self.glob_mean_ + bias
        if self.item_bias_ is not None:
            p = p + np.asarray(self.item_bias_)[i]
        return p

    def transform(self, X=None, y=None, U=None, U_bin=None, W=None,
                  replace_existing=False):
        """Impute missing X for new rows (sklearn-style; reference:
        /root/reference/cmfrec/__init__.py:4027)."""
        X = np.asarray(X, np.float64)
        a, bias = self.factors_multiple(X=X, U=U, U_bin=U_bin, W=W,
                                        return_bias=True)
        pred = a[:, self.k_user:] @ self._xB.T + self.glob_mean_
        pred = pred + bias[:, None]
        if self.item_bias_ is not None:
            pred = pred + self.item_bias_[None, :]
        if replace_existing:
            return pred
        out = X.copy()
        nanmask = np.isnan(out)
        out[nanmask] = pred[nanmask]
        return out

    def force_precompute_for_predictions(self):
        from ..solvers.warm import build_precomputed

        self._precomputed = build_precomputed(self)
        return self

    @staticmethod
    def from_model_matrices(A, B, glob_mean=0.0, precompute=True,
                            user_bias=None, item_bias=None,
                            lambda_=1e1, scale_lam=False, l1_lambda=0.0,
                            nonneg=False, NA_as_zero=False,
                            scaling_biasA=None, scaling_biasB=None,
                            use_float=True, nthreads=-1, n_jobs=None):
        """Build a predict-capable CMF from existing factor matrices
        (reference: /root/reference/cmfrec/__init__.py:4186)."""
        A = np.asarray(A)
        B = np.asarray(B)
        if A.shape[1] != B.shape[1]:
            raise ValueError("A and B must have the same number of columns")
        model = CMF(k=A.shape[1], lambda_=lambda_, scale_lam=scale_lam,
                    l1_lambda=l1_lambda, nonneg=nonneg, NA_as_zero=NA_as_zero,
                    user_bias=user_bias is not None,
                    item_bias=item_bias is not None, use_float=use_float)
        model._reset()
        model.dtype_ = resolve_dtype(use_float)
        model.A_ = A.astype(model.dtype_)
        model.B_ = B.astype(model.dtype_)
        model.user_bias_ = None if user_bias is None else np.asarray(user_bias)
        model.item_bias_ = None if item_bias is None else np.asarray(item_bias)
        model.glob_mean_ = float(glob_mean)
        if scaling_biasA is not None:
            model.scale_bias_const = True
            model.scaling_biasA_ = float(scaling_biasA)
        if scaling_biasB is not None:
            model.scale_bias_const = True
            model.scaling_biasB_ = float(scaling_biasB)
        model.is_fitted_ = True
        if precompute:
            model.force_precompute_for_predictions()
        return model


class CMF_implicit(_BaseModel):
    """Implicit-feedback WRMF/iALS with optional side info (reference:
    /root/reference/cmfrec/__init__.py:4358)."""

    _supports_extra_side_rows = True

    def __init__(self, k=50, lambda_=1e0, alpha=1.0, use_cg=True,
                 k_user=0, k_item=0, k_main=0,
                 w_main=1.0, w_user=1.0, w_item=1.0,
                 l1_lambda=0.0, center_U=True, center_I=True,
                 niter=10, max_cg_steps=3, precondition_cg=False,
                 finalize_chol=False,
                 NA_as_zero_user=False, NA_as_zero_item=False,
                 nonneg=False, nonneg_C=False, nonneg_D=False,
                 max_cd_steps=100,
                 apply_log_transf=False, downweight=False,
                 precompute_for_predictions=True,
                 use_float=True, random_state=1, verbose=False,
                 print_every=10, handle_interrupt=True, produce_dicts=False,
                 nthreads=-1, n_jobs=None,
                 checkpoint_path=None, checkpoint_every=0):
        self.k = k
        self.lambda_ = lambda_
        self.alpha = alpha
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.use_cg = use_cg
        self.k_user = k_user
        self.k_item = k_item
        self.k_main = k_main
        self.w_main = w_main
        self.w_user = w_user
        self.w_item = w_item
        self.l1_lambda = l1_lambda
        self.center_U = center_U
        self.center_I = center_I
        self.niter = niter
        self.max_cg_steps = max_cg_steps
        self.precondition_cg = precondition_cg
        self.finalize_chol = finalize_chol
        self.NA_as_zero_user = NA_as_zero_user
        self.NA_as_zero_item = NA_as_zero_item
        self.nonneg = nonneg
        self.nonneg_C = nonneg_C
        self.nonneg_D = nonneg_D
        self.max_cd_steps = max_cd_steps
        self.apply_log_transf = apply_log_transf
        self.downweight = downweight
        self.precompute_for_predictions = precompute_for_predictions
        self.use_float = use_float
        self.random_state = random_state
        self.verbose = verbose
        self.print_every = print_every
        self.handle_interrupt = handle_interrupt
        self.produce_dicts = produce_dicts
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.is_fitted_ = False
        _validate_cmf_params(self, implicit=True)

    def fit(self, X, U=None, I=None, mesh=None):
        """Fit to implicit-feedback data (reference:
        /root/reference/cmfrec/__init__.py:4816).  ``mesh`` runs the
        WRMF iterations row-sharded over the device mesh."""
        _validate_cmf_params(self, implicit=True)
        from ..config import set_handle_interrupt

        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, _, m, n = self._ingest_X(X)
        if U is None and I is None and self.k_user == 0 and self.k_item == 0 \
                and self.k_main == 0:
            res = drivers.fit_implicit_als(
                rows, cols, vals, m, n, mesh=mesh,
                k=self.k, lambda_=self.lambda_, l1_lambda=self.l1_lambda,
                niter=self.niter, use_cg=self.use_cg,
                max_cg_steps=self.max_cg_steps,
                precondition_cg=self.precondition_cg,
                finalize_chol=self.finalize_chol,
                alpha=self.alpha, apply_log_transf=self.apply_log_transf,
                adjust_weight=self.downweight, nonneg=self.nonneg,
                max_cd_steps=self.max_cd_steps, dtype=self.dtype_,
                seed=self.random_state, verbose=self.verbose,
                checkpoint_path=self.checkpoint_path,
                checkpoint_every=self.checkpoint_every,
            )
        else:
            from ..solvers.collective import fit_collective_implicit_als

            side_U = self._ingest_side(U, self.user_mapping_, m, "U")
            side_I = self._ingest_side(I, self.item_mapping_, n, "I")
            res = fit_collective_implicit_als(
                rows, cols, vals, m, n, mesh=mesh,
                side_U=side_U, side_I=side_I,
                k=self.k, k_user=self.k_user, k_item=self.k_item,
                k_main=self.k_main,
                lambda_=self.lambda_, l1_lambda=self.l1_lambda,
                w_main=self.w_main, w_user=self.w_user, w_item=self.w_item,
                alpha=self.alpha, apply_log_transf=self.apply_log_transf,
                adjust_weight=self.downweight,
                niter=self.niter, use_cg=self.use_cg,
                max_cg_steps=self.max_cg_steps,
                precondition_cg=self.precondition_cg,
                finalize_chol=self.finalize_chol,
                center_U=self.center_U, center_I=self.center_I,
                NA_as_zero_user=self.NA_as_zero_user,
                NA_as_zero_item=self.NA_as_zero_item,
                nonneg=self.nonneg, nonneg_C=self.nonneg_C,
                nonneg_D=self.nonneg_D, max_cd_steps=self.max_cd_steps,
                dtype=self.dtype_, seed=self.random_state,
                verbose=self.verbose,
                checkpoint_path=self.checkpoint_path,
                checkpoint_every=self.checkpoint_every,
            )
            self.C_ = res.get("C")
            self.D_ = res.get("D")
            self.U_colmeans_ = res.get("U_colmeans")
            self.I_colmeans_ = res.get("I_colmeans")
        self.A_ = res["A"]
        self.B_ = res["B"]
        self.user_bias_ = None
        self.item_bias_ = None
        self.glob_mean_ = 0.0
        self.w_main_multiplier_ = res.get("w_main_multiplier", 1.0)
        self.is_fitted_ = True
        self._build_dicts()
        if self.precompute_for_predictions:
            self.force_precompute_for_predictions()
        return self

    def factors_warm(self, X_col=None, X_val=None, U=None, U_col=None,
                     U_val=None):
        """WRMF factors for a new user (reference:
        /root/reference/cmfrec/__init__.py:5231)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        cols, _ = self._map_ids(np.asarray(X_col), self.item_mapping_, "item")
        cols = np.atleast_1d(cols).astype(np.int64)
        vals = np.asarray(X_val, np.float64).ravel()
        if self.apply_log_transf:
            vals = np.log(vals)
        u_row = CMF._new_row_U(self, U, U_col, U_val)  # [1, p] or None
        a = factors_implicit_batch(
            self, cols[None, :], vals[None, :],
            np.array([len(cols)], np.int64),
            U=u_row,
        )
        return a[0]

    def factors_cold(self, U=None, U_col=None, U_val=None):
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        if self.C_ is None:
            raise ValueError("Model was fit without user side info")
        from ..solvers.warm import factors_cold_implicit

        if U is None:
            p = self.C_.shape[0]
            U = np.full(p, np.nan)
            U[np.asarray(U_col, np.int64)] = np.asarray(U_val, np.float64)
        return factors_cold_implicit(self, np.asarray(U, np.float64)[None, :])[0]

    def topN_warm(self, n=10, X_col=None, X_val=None, U=None, U_col=None,
                  U_val=None, include=None, exclude=None, output_score=False):
        a = self.factors_warm(X_col=X_col, X_val=X_val, U=U, U_col=U_col,
                              U_val=U_val)
        return self._topN_vec(a[self.k_user:], 0.0, n, include, exclude,
                              output_score)

    def topN_cold(self, n=10, U=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        a = self.factors_cold(U=U, U_col=U_col, U_val=U_val)
        return self._topN_vec(a[self.k_user:], 0.0, n, include, exclude,
                              output_score)

    def predict_warm(self, items, X_col, X_val, U=None, U_col=None,
                     U_val=None):
        a = self.factors_warm(X_col=X_col, X_val=X_val, U=U, U_col=U_col,
                              U_val=U_val)
        i, _ = self._map_ids(items, self.item_mapping_, "item")
        return self._xB[np.atleast_1d(i)] @ a[self.k_user:]

    def predict_cold(self, items, U=None, U_col=None, U_val=None):
        a = self.factors_cold(U=U, U_col=U_col, U_val=U_val)
        i, _ = self._map_ids(items, self.item_mapping_, "item")
        return self._xB[np.atleast_1d(i)] @ a[self.k_user:]

    def factors_multiple(self, X=None, U=None):
        """WRMF warm factors for many new users at once (reference:
        /root/reference/cmfrec/__init__.py:5107)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        if X is None:
            from ..solvers.warm import factors_cold_implicit

            return factors_cold_implicit(self, np.asarray(U, np.float64))
        rows, cols, vals, _, m_new, _ = self._ingest_X_new(X, None)
        if self.apply_log_transf:
            vals = np.log(vals)  # same contract as fit/factors_warm
        if _route_grouped(rows, m_new):
            # degree-grouped serving path (see CMF.factors_multiple)
            from ..solvers.warm import factors_implicit_grouped

            return factors_implicit_grouped(
                self, rows, cols, vals, m_new,
                U=None if U is None else np.asarray(U, np.float64))
        from ..solvers.warm import pack_padded_rows

        idx, vv, _, counts = pack_padded_rows(rows, cols, vals, None, m_new)
        return factors_implicit_batch(
            self, idx, vv, counts,
            U=None if U is None else np.asarray(U, np.float64))

    def predict_warm_multiple(self, X, item, U=None):
        """Predict (new user row i, item[i]) pairs (reference:
        /root/reference/cmfrec/__init__.py:5306)."""
        a = self.factors_multiple(X=X, U=U)
        i, _ = self._map_ids(item, self.item_mapping_, "item")
        i = np.atleast_1d(i)
        if i.shape[0] != a.shape[0]:
            raise ValueError("item must have one entry per row of X")
        return np.sum(a[:, self.k_user:] * np.asarray(self._xB)[i], axis=1)

    def predict_cold_multiple(self, item, U=None):
        """Predict for many (new user given side info, existing item) pairs
        (reference: /root/reference/cmfrec/__init__.py:5221)."""
        from ..solvers.warm import factors_cold_implicit

        a = factors_cold_implicit(self, np.asarray(U, np.float64))
        i, _ = self._map_ids(item, self.item_mapping_, "item")
        i = np.atleast_1d(i)
        return np.sum(a[:, self.k_user:] * np.asarray(self._xB)[i], axis=1)

    def item_factors_cold(self, I=None, I_col=None, I_val=None):
        """Factors for a new item from its side info — the swapped-role
        dual of factors_cold (reference: __init__.py:5061)."""
        if self.D_ is None:
            raise ValueError("Model was fit without item side info")
        return self.swap_users_and_items(precompute=False).factors_cold(
            U=I, U_col=I_col, U_val=I_val
        )

    def predict_new(self, user, I=None):
        """Predict for (existing user, new item given side info) pairs
        (reference: /root/reference/cmfrec/__init__.py:5402)."""
        I = np.asarray(I, np.float64)
        if I.ndim == 1:
            I = I[None, :]
        sw = self.swap_users_and_items(precompute=False)
        from ..solvers.warm import factors_cold_implicit

        b = factors_cold_implicit(sw, I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        u = np.atleast_1d(u)
        return np.sum(np.asarray(self._xA)[u] * b[:, self.k_item:], axis=1)

    def topN_new(self, user, I=None, n=10, output_score=False):
        """Rank a pool of NEW items (given side info) for an existing user
        (reference: /root/reference/cmfrec/__init__.py:5465)."""
        I = np.asarray(I, np.float64)
        sw = self.swap_users_and_items(precompute=False)
        from ..solvers.warm import factors_cold_implicit

        b = factors_cold_implicit(sw, I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        scores = b[:, self.k_item:] @ np.asarray(self._xA)[int(u)]
        n = min(n, scores.shape[0])
        idx = np.argpartition(-scores, n - 1)[:n]
        idx = idx[np.argsort(-scores[idx])]
        return (idx, scores[idx]) if output_score else idx

    def force_precompute_for_predictions(self):
        from ..solvers.warm import build_precomputed

        self._precomputed = build_precomputed(self)
        return self

    @staticmethod
    def from_model_matrices(A, B, precompute=True, lambda_=1e0,
                            l1_lambda=0.0, nonneg=False, apply_log_transf=False,
                            alpha=1.0, use_float=True, nthreads=-1, n_jobs=None):
        A = np.asarray(A)
        B = np.asarray(B)
        if A.shape[1] != B.shape[1]:
            raise ValueError("A and B must have the same number of columns")
        model = CMF_implicit(k=A.shape[1], lambda_=lambda_, l1_lambda=l1_lambda,
                             nonneg=nonneg, apply_log_transf=apply_log_transf,
                             alpha=alpha, use_float=use_float)
        model._reset()
        model.dtype_ = resolve_dtype(use_float)
        model.A_ = A.astype(model.dtype_)
        model.B_ = B.astype(model.dtype_)
        model.glob_mean_ = 0.0
        model.w_main_multiplier_ = 1.0
        model.is_fitted_ = True
        if precompute:
            model.force_precompute_for_predictions()
        return model
