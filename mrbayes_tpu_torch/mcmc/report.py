"""Posterior reporting: ancestral states, site rates, positive selection.

Counterpart of ``mrbayes_tpu/mcmc/report.py``: the reference's ``report
ancstates/siterates/possel/siteomega`` sample-time columns (headers
src/mcmc.c:12566-12798, value rows :13020-13140, up-pass CondLikeUp_*
src/likelihood.c:4574-4938, PrintSiteRates_Gen :12212,
PosSelProbs/SiteOmegas :12297ff).

Once a sample, for each run's cold chain at once: a down-pass keeping
every node's partials and an up-pass (``ops/pruning.final_partials``,
plain PyTorch ops on the device), then closed-form per-pattern
posteriors, gathered into each reported site's column.  ``compute``
returns one [runs, columns] tensor on the device; the runner packs it
into its one device->host copy a sample (``run.host_states``), so the
columns add no host synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nexus.datatypes import AA_ORDER, DataType
from ..ops.pruning import final_partials
from ..ops.traversal import ancestor_matrix
from .engine import Engine

_TINY = 1e-30


def _state_labels(cfg) -> list[str]:
    """Display labels per model state (reference StateCode /
    State_CODON, src/mcmc.c:12729)."""
    d = cfg.div
    if cfg.codon is not None:
        from ..models.codes import BASES
        return ["".join(BASES[b] for b in cfg.codon.bases[k])
                for k in range(cfg.codon.n_states)]
    if d.dtype in (DataType.DNA, DataType.RNA):
        return list("ACGT")
    if d.dtype is DataType.PROTEIN:
        return [c.upper() for c in AA_ORDER]
    return [str(k) for k in range(d.n_states)]


class Reporter:
    """The extra .p columns for one engine and report-option set.

    ``opts``: {key: (value, user_division_tuple)} from the report command.
    Divisions that cannot report (parsimony model, covarion, adgamma,
    symdiri, doublets) are skipped with JAX's log notes, as the reference
    enables printAncStates only for supported models
    (src/mcmc.c:18012-18060); a BEST run reports nothing
    (mrbayes_tpu/mcmc/report.py:60-63)."""

    def __init__(self, eng: Engine, opts: dict, log=print):
        self.eng = eng
        self.log = log
        self.headers: list[str] = []
        self._div_plan: list[dict] = []
        if eng.best:
            if any(v == "yes" for v, _ in opts.values()):
                log("   [report: not supported for BEST/speciestree runs]")
            return

        def want(key):
            v = opts.get(key)
            return v[1] if v and v[0].startswith("y") else None

        w_anc, w_rates = want("ancstates"), want("siterates")
        w_possel, w_omega = want("possel"), want("siteomega")
        # hard-constraint masks for the MRCA lookup: on an unrooted tree
        # (rooted at tip 0) a split holding tip 0 shows as its complement
        self.con_names = list(eng.constraint_names)
        self.con_masks = None
        if eng.constraint_masks is not None and self.con_names:
            m = np.array(eng.constraint_masks, bool)
            if not eng.tree_settings.clock:
                m[m[:, 0]] = ~m[m[:, 0]]
            self.con_masks = m
        if w_anc is not None and self.con_masks is None:
            log("   [report ancstates=yes: no active hard constraints; "
                "ancestral states are reported for constrained nodes "
                "only (reference src/mcmc.c:13129-13147)]")

        for i, cfg in enumerate(eng.div_cfg):
            ineligible = (not cfg.prunes or cfg.ratecorr_group >= 0
                          or cfg.covarion or cfg.symdiri or cfg.doublet)
            ui = cfg.div.user_index
            plan = {"div": i, "anc": False, "rates": False,
                    "possel": False, "omega": False}
            if w_anc is not None and ui in w_anc \
                    and self.con_masks is not None:
                if ineligible:
                    log(f"   [report ancstates: division {ui + 1} model "
                        "not supported (parsimony/covarion/adgamma/"
                        "symdiri/doublet)]")
                else:
                    plan["anc"] = True
            if w_rates is not None and ui in w_rates and not ineligible \
                    and cfg.shape_group >= 0 and cfg.codon is None:
                plan["rates"] = True
            has_classes = (cfg.ny98_group >= 0 or cfg.m3_group >= 0
                           or cfg.m10_group >= 0)
            if w_possel is not None and ui in w_possel and has_classes:
                plan["possel"] = True
            if w_omega is not None and ui in w_omega and has_classes:
                plan["omega"] = True
            if any(plan[k] for k in ("anc", "rates", "possel", "omega")):
                # each reported site's pattern, on the device
                plan["pat"] = torch.as_tensor(self._chars_of(cfg)[1],
                                              device=eng.device)
                self._div_plan.append(plan)
        self._build_headers()
        if self.con_masks is not None:
            self._con_dev = torch.as_tensor(self.con_masks,
                                            dtype=torch.float32,
                                            device=eng.device)

    # ------------------------------------------------------------ headers
    @staticmethod
    def _chars_of(cfg):
        """(original 1-based char tuples, pattern index) per reported
        site, in original-alignment order within the division."""
        d = cfg.div
        if cfg.codon is not None:
            trips = np.sort(np.asarray(d.char_ids)).reshape(-1, 3)
            return ([tuple(int(c) + 1 for c in t) for t in trips],
                    np.asarray(cfg.codon_site_pattern))
        order = np.argsort(d.char_ids)
        return ([(int(d.char_ids[j]) + 1,) for j in order],
                np.asarray(d.pattern_of_char)[order])

    def _build_headers(self):
        eng = self.eng
        for plan in self._div_plan:
            cfg = eng.div_cfg[plan["div"]]
            chars, _ = self._chars_of(cfg)
            if plan["rates"]:
                self.headers += [f"r({c[0]})" for c in chars]
            if plan["possel"]:
                self.headers += ["pr+(" + ",".join(map(str, t)) + ")"
                                 for t in chars]
            if plan["omega"]:
                self.headers += ["omega(" + ",".join(map(str, t)) + ")"
                                 for t in chars]
            if plan["anc"]:
                labels = _state_labels(cfg)
                for cname in self.con_names:
                    for t in chars:
                        at = ",".join(map(str, t)) + "@" + cname
                        self.headers += [f"p({lb}){{{at}}}"
                                         for lb in labels]

    # ------------------------------------------------------------ compute
    def _div_tree_view(self, cold, i):
        """(left, right, parent, substitution-unit blen) [R, n_nodes] of
        division i's tree: a clock tree's lengths from its (pinned) ages
        and rates, an unlinked tree's own fields."""
        eng = self.eng
        if eng.n_trees > 1:
            cold = eng.tree_view(cold, eng.div_tree[i])
        return (cold["left"], cold["right"], cold["parent"],
                eng.branch_lengths(cold))

    def _div_model(self, cold, i):
        """(lam, U, Uinv, pi, rates [R|1, K], cat_weights [R, K] or None,
        pinv [R] or 0.0, mult, a codon division's omegas [R, K]) of
        division i, through the engine's own wiring
        (``Engine._division_lnL`` and ``_codon_lnL``)."""
        eng = self.eng
        cfg = eng.div_cfg[i]
        lam, U, Uinv = eng._division_eig_cached(cold, i)[:3]
        pi = eng._division_pi(cold, i)
        if cfg.codon is not None:
            omegas, weights = eng._codon_omegas(cold, cfg)
            rates = eng._unit_rates.expand(1, omegas.shape[-1])
            return (lam, U, Uinv, pi, rates, weights, 0.0,
                    3.0 * eng._rate_mult(cold, i), omegas)
        rates = eng._category_rates(cold, cfg)
        pinv = (cold["pinvar"][:, cfg.pinvar_group]
                if cfg.pinvar_group >= 0 else 0.0)
        return (lam, U, Uinv, pi, rates, None, pinv, eng._rate_mult(cold, i),
                None)

    def compute(self, states, slots) -> torch.Tensor:
        """Every column's value for the chains ``slots`` (a device index
        tensor [R]): [R, len(headers)] on the device, no host sync."""
        eng = self.eng
        R = slots.shape[0]
        if not self._div_plan:
            return torch.zeros((R, 0), device=slots.device)
        cold = {k: v.index_select(0, slots) for k, v in states.items()}
        out = []
        for plan in self._div_plan:
            i = plan["div"]
            cfg = eng.div_cfg[i]
            pat = plan["pat"]
            left, right, parent, blen = self._div_tree_view(cold, i)
            (lam, U, Uinv, pi, rates, cat_w, pinv, mult,
             omegas) = self._div_model(cold, i)
            K = rates.shape[-1]
            if cat_w is None:
                cat_w = rates.new_full((1, K), 1.0 / K)
            has_pinv = cfg.pinvar_group >= 0
            pinv_r = (pinv[:, None] if torch.is_tensor(pinv)
                      else blen.new_full((1, 1), pinv))         # [R|1, 1]
            D, F, flog, logscale = final_partials(
                left, right, parent, blen, eng.tip_partials[i], lam, U,
                Uinv, rates.expand(R, K), pinv, eng.n_tips, mult)
            root = eng.n_nodes - 1
            Lk = torch.einsum("rpks,rs->rpk", D[:, root], pi)   # [R, P, K]
            cmask = eng.const_masks[i]
            if plan["rates"]:
                # posterior-mean site rate (reference PrintSiteRates_Gen,
                # src/mcmc.c:12212: category frequencies cancel; the base
                # rate compensated for pinvar), in log space for the
                # pinvar mixture
                mult_r = mult[:, None] if torch.is_tensor(mult) else mult
                base = mult_r / torch.clamp_min(1.0 - pinv_r, 1e-6)
                log_var = torch.log1p(-torch.clamp_max(pinv_r, 1 - 1e-7))
                num = base * (Lk * (rates * cat_w)[:, None, :]).sum(-1)
                ln_num = torch.log(torch.clamp_min(num, _TINY)) + logscale \
                    + log_var
                ln_var = torch.log(torch.clamp_min(
                    (Lk * cat_w[:, None, :]).sum(-1), _TINY)) + logscale \
                    + log_var
                if has_pinv:
                    ln_inv = torch.log(torch.clamp_min(pinv_r, _TINY)) \
                        + torch.log(torch.clamp_min(
                            torch.einsum("ps,rs->rp", cmask, pi), _TINY))
                    ln_den = torch.logaddexp(ln_var, ln_inv)
                else:
                    ln_den = ln_var
                out.append(torch.exp(ln_num - ln_den)[:, pat])
            if plan["possel"] or plan["omega"]:
                q = Lk * cat_w[:, None, :]
                q = q / torch.clamp_min(q.sum(-1, keepdim=True), _TINY)
                if plan["possel"]:
                    # P(site in a class with omega > 1) (reference
                    # PosSelProbs, src/mcmc.c:12297)
                    out.append(torch.einsum(
                        "rpk,rk->rp", q, (omegas > 1.0).to(q.dtype))[:, pat])
                if plan["omega"]:
                    out.append(torch.einsum(
                        "rpk,rk->rp", q, omegas.to(q.dtype))[:, pat])
            if plan["anc"]:
                # each constraint's MRCA in the current topology
                A = ancestor_matrix(parent)                  # [R, n, n]
                tipA = A[:, :eng.n_tips]
                sizes = tipA.sum(1)                          # [R, n]
                m = self._con_dev                            # [M, n_tips]
                counts = torch.einsum("mt,rtn->rmn", m, tipA)
                ok = counts >= m.sum(1)[None, :, None] - 0.5
                mrca = torch.argmin(torch.where(
                    ok, sizes[:, None, :], 1e9), dim=2)      # [R, M]
                rr = torch.arange(R, device=mrca.device)[:, None]
                Fv = F[rr, mrca]                             # [R,M,P,K,S]
                fl = flog[rr, mrca]                          # [R, M, P]
                ln_pi = torch.log(torch.clamp_min(pi, _TINY))[:, None,
                                                               None, :]
                ln_var = torch.log(torch.clamp_min(torch.einsum(
                    "rmpks,rk->rmps", Fv, cat_w), _TINY)) + ln_pi \
                    + (logscale[:, None, :] + fl)[..., None]
                if has_pinv:
                    ln_var = ln_var + torch.log1p(
                        -torch.clamp_max(pinv_r, 1 - 1e-7))[:, :, None,
                                                             None]
                    ln_inv = torch.log(torch.clamp_min(pinv_r, _TINY))[
                        :, :, None, None] + torch.log(torch.clamp_min(
                            cmask, _TINY))[None, None] + ln_pi
                    ln_post = torch.logaddexp(ln_var, ln_inv)
                else:
                    ln_post = ln_var
                post = torch.softmax(ln_post, dim=-1)       # [R, M, P, S]
                out.append(post[:, :, pat].reshape(R, -1))
        return torch.cat([o.float() for o in out], -1)

    def cold_slots(self, bk) -> torch.Tensor:
        """Each run's cold-chain slot [R] on the device (``temp_id``'s
        argmin within the run), without a host sync."""
        nc = self.eng.mcmc.nchains
        tid = bk["temp_id"].reshape(-1, nc)
        base = torch.arange(tid.shape[0], device=tid.device) * nc
        return base + torch.argmin(tid, dim=1)
