"""Plain PyTorch versions of the sLSTM recurrence kernel and of its
backward: the time loop of ``repro.models.xlstm.slstm_block``'s
``lax.scan``, as the port ran it in ``models/xlstm.py`` before the kernel,
a reverse loop in the backward kernel's order of operations, and that loop
split as the cluster layout's two kernels split it: a chain loop, then a
rest pass."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["slstm_scan_bwd_chain_ref", "slstm_scan_bwd_ref", "slstm_scan_bwd_rest_ref",
           "slstm_scan_ref"]


def slstm_scan_ref(zx, ix, fx, ox, rw, c, n, h, m, save: bool = False):
    """The time loop. Gate inputs (B, S, d) float32, ``rw`` (d, d) float32,
    the state c, n, h, m (B, d) float32. Returns (h (B, S, d), c, n, h, m
    after the last step) and, with ``save``, also every step's c, n, m and
    z = tanh(zx_t + h_{t-1} @ rw), each (B, S, d): what the backward reads.
    Differentiable."""
    # Elementwise in the input alone, so computed for every step at once.
    log_f, o = F.logsigmoid(fx), torch.sigmoid(ox)
    hs, steps = [], []
    for t in range(zx.shape[1]):
        zt = torch.tanh(zx[:, t] + h @ rw)
        m_new = torch.maximum(log_f[:, t] + m, ix[:, t])
        i_p = torch.exp(ix[:, t] - m_new)
        f_p = torch.exp(log_f[:, t] + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = o[:, t] * c / n.clamp_min(1.0)
        m = m_new
        hs.append(h)
        if save:
            steps.append((c, n, m, zt))
    out = (torch.stack(hs, dim=1), c, n, h, m)
    return out + tuple(torch.stack(s, dim=1) for s in zip(*steps)) if save else out


def _log_sigmoid_grad(x):
    """d log_sigmoid(x) / dx as torch's ``log_sigmoid_backward`` computes it:
    with z = exp(-|x|), 1 - z / (1 + z) below 0, z / (1 + z) from 0 (NaN
    where x is NaN)."""
    z = torch.exp(-x.abs())
    s = z / (1.0 + z)
    return torch.where(x < 0, 1.0 - s, s)


def slstm_scan_bwd_ref(dhs, dc, dn, dh, dm, ix, fx, ox, rw, c0, n0, m0, cs, ns, ms, zs):
    """The backward of the time loop but for ``rw``'s gradient: the CPU twin
    of the ``slstm_scan_bwd`` kernel, a reverse loop in its order of
    operations.

    dhs (B, S, d): the gradient of every step's output; dc, dn, dh, dm (B,
    d): those of the state after the last step. Any of them may be None
    (zero). ix, fx, ox (B, S, d), rw (d, d), the entering state c0, n0, m0
    (B, d), and the forward's saved c, n, m, z of every step (B, S, d). All
    float32. Returns (dzx, dix, dfx, dox (B, S, d), dc0, dn0, dh0, dm0 (B,
    d)); dzx is the gradient of z's pre-activation, which the caller
    multiplies by the previous outputs for ``rw``'s gradient.

    Per step t, from the last back, with dh_t = dhs_t + (the final dh at
    t = S - 1, else dzx_{t+1} @ rw^T) and dc, dn, dm carried from step t + 1:

        dq = dh_t / max(n_t, 1)             dc' = dc + dq o       dz = dc' i'
        dzx_t = dz (1 - z_t^2)              dn' = dn + [n_t >= 1] (-dh_t ((o c_t / max(n_t, 1)) / max(n_t, 1)))
        dox_t = dq c_t (1 - o) o            di = dc' z_t + dn'    df = dc' c_{t-1} + dn' n_{t-1}
        dc = dc' f', dn = dn' f'            gi = di i', gf = df f'
        dm_t = dm - gi - gf, split by max(lf + m_{t-1}, ix_t) as torch.maximum's
        backward splits it (half to each side at a tie, all to both at NaN)
        dix_t = gi + its share;             dm = gf + lf's share; dfx_t = dm log_sigmoid'(fx_t)

    The tie rules are those of autograd through ``slstm_scan_ref``: the
    gradient of max(n_t, 1) goes all to n_t at n_t == 1 (``clamp_min``), the
    reference's ``jnp.maximum`` splits that tie. From a fresh state step 0
    always sits on it (i' = exp(0) = 1, f' = 0, n_0 = 1), and there the two
    differ only by rounding: n_0's gradient reaches only i' = exp(ix_0 -
    m_0) with m_0 = ix_0, whose two paths into ix_0 cancel.
    """
    B, S, d = ix.shape
    zero = ix.new_zeros(B, d)
    log_f, o = F.logsigmoid(fx), torch.sigmoid(ox)
    # What needs no gradient, for every step at once (the kernel computes it
    # while the previous step's dzx is on its way).
    m_prev = torch.cat([m0[:, None], ms[:, :-1]], dim=1)
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    n_prev = torch.cat([n0[:, None], ns[:, :-1]], dim=1)
    lfm = log_f + m_prev
    i_p = torch.exp(ix - ms)
    f_p = torch.exp(lfm - ms)
    nd = ns.clamp_min(1.0)
    qnn = o * cs / nd / nd
    zz = 1.0 - zs * zs
    lsg = _log_sigmoid_grad(fx)
    dzx, dix, dfx, dox = (torch.empty_like(ix) for _ in range(4))
    dc = zero if dc is None else dc
    dn = zero if dn is None else dn
    dm = zero if dm is None else dm
    carry = zero if dh is None else dh
    rwt = rw.t()
    for t in range(S - 1, -1, -1):
        g = carry if dhs is None else dhs[:, t] + carry
        dq = g / nd[:, t]
        dcp = dc + dq * o[:, t]
        da = dcp * i_p[:, t] * zz[:, t]
        dzx[:, t] = da
        carry = da @ rwt
        dnp = dn + torch.where(ns[:, t] >= 1.0, -g * qnn[:, t], zero)
        dox[:, t] = dq * cs[:, t] * (1.0 - o[:, t]) * o[:, t]
        di = dcp * zs[:, t] + dnp
        df = dcp * c_prev[:, t] + dnp * n_prev[:, t]
        dc = dcp * f_p[:, t]
        dn = dnp * f_p[:, t]
        gi = di * i_p[:, t]
        gf = df * f_p[:, t]
        dmt = dm - gi - gf
        a, b = lfm[:, t], ix[:, t]
        half = torch.where(a == b, dmt / 2, dmt)
        dix[:, t] = gi + torch.where(a > b, zero, half)
        dm = gf + torch.where(a < b, zero, half)
        dfx[:, t] = dm * lsg[:, t]
    return dzx, dix, dfx, dox, dc, dn, carry, dm


def _previous(first, steps):
    """Every step's value of the step before: ``first`` (B, d) at step 0."""
    return torch.cat([first[:, None], steps[:, :-1]], dim=1)


def slstm_scan_bwd_chain_ref(dhs, dc, dn, dh, dm, ix, fx, ox, rw, c0, n0, m0, cs, ns, ms, zs):
    """The serial part of ``slstm_scan_bwd_ref``: the plain version of the
    cluster layout's loop kernel. Takes that function's arguments (it reads
    dhs, dc, dh, ix, fx, ox, rw, m0, ns, ms, zs) and returns (dzx, dh_all,
    dh0): dz_pre of every step, every step's dh_t = dhs_t + (the final dh at
    t = S - 1, else dzx_{t+1} @ rw^T) (B, S, d), and the entering h's
    gradient. Per step only the chain: dq = dh_t / max(n_t, 1), dc' = dc + dq
    o, dzx_t = dc' i' (1 - z_t^2), dc = dc' f'. Each value rounds as in
    ``slstm_scan_bwd_ref``."""
    B, S, d = ix.shape
    zero = ix.new_zeros(B, d)
    o = torch.sigmoid(ox)
    lfm = F.logsigmoid(fx) + _previous(m0, ms)
    i_p = torch.exp(ix - ms)
    f_p = torch.exp(lfm - ms)
    nd = ns.clamp_min(1.0)
    zz = 1.0 - zs * zs
    dzx, dh_all = torch.empty_like(ix), torch.empty_like(ix)
    dc = zero if dc is None else dc
    carry = zero if dh is None else dh
    rwt = rw.t()
    for t in range(S - 1, -1, -1):
        g = carry if dhs is None else dhs[:, t] + carry
        dh_all[:, t] = g
        dcp = dc + g / nd[:, t] * o[:, t]
        da = dcp * i_p[:, t] * zz[:, t]
        dzx[:, t] = da
        carry = da @ rwt
        dc = dcp * f_p[:, t]
    return dzx, dh_all, carry


def slstm_scan_bwd_rest_ref(dh_all, dc, dn, dm, ix, fx, ox, c0, n0, m0, cs, ns, ms, zs):
    """The rest of ``slstm_scan_bwd_ref`` given every step's dh_t
    (``slstm_scan_bwd_chain_ref``'s second output): the plain version of the
    cluster layout's rest kernel. dn, dm and dc are recurrences of one
    (row, column) each, so no step of it waits on another column. Returns
    (dix, dfx, dox (B, S, d), dc0, dn0, dm0 (B, d)), each value rounded as
    in ``slstm_scan_bwd_ref``."""
    B, S, d = ix.shape
    zero = ix.new_zeros(B, d)
    o = torch.sigmoid(ox)
    c_prev, n_prev = _previous(c0, cs), _previous(n0, ns)
    lfm = F.logsigmoid(fx) + _previous(m0, ms)
    i_p = torch.exp(ix - ms)
    f_p = torch.exp(lfm - ms)
    nd = ns.clamp_min(1.0)
    qnn = o * cs / nd / nd
    lsg = _log_sigmoid_grad(fx)
    dix, dfx, dox = (torch.empty_like(ix) for _ in range(3))
    dc = zero if dc is None else dc
    dn = zero if dn is None else dn
    dm = zero if dm is None else dm
    for t in range(S - 1, -1, -1):
        g = dh_all[:, t]
        dq = g / nd[:, t]
        dcp = dc + dq * o[:, t]
        dnp = dn + torch.where(ns[:, t] >= 1.0, -g * qnn[:, t], zero)
        dox[:, t] = dq * cs[:, t] * (1.0 - o[:, t]) * o[:, t]
        di = dcp * zs[:, t] + dnp
        df = dcp * c_prev[:, t] + dnp * n_prev[:, t]
        dc = dcp * f_p[:, t]
        dn = dnp * f_p[:, t]
        gi = di * i_p[:, t]
        gf = df * f_p[:, t]
        dmt = dm - gi - gf
        a, b = lfm[:, t], ix[:, t]
        half = torch.where(a == b, dmt / 2, dmt)
        dix[:, t] = gi + torch.where(a > b, zero, half)
        dm = gf + torch.where(a < b, zero, half)
        dfx[:, t] = dm * lsg[:, t]
    return dix, dfx, dox, dc, dn, dm
