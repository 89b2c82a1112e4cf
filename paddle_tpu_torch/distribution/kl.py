"""The KL divergence registry: ``register_kl`` and the most specific
match, with the closed forms of ``paddle_tpu/distribution/kl.py``."""
from __future__ import annotations

import torch

from .continuous import (Beta, Dirichlet, Exponential, Gumbel, Laplace,
                         LogNormal, Normal, Uniform)
from .discrete import Bernoulli, Categorical
from .distribution import ExponentialFamily, _sum_rightmost, _with_grad
from .transformed_distribution import Independent

__all__ = ["kl_divergence", "register_kl"]

_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def decorator(fn):
        _REGISTRY[(p_cls, q_cls)] = fn
        return fn

    return decorator


def _dispatch(p_cls, q_cls):
    matches = [(sp, sq) for (sp, sq) in _REGISTRY
               if issubclass(p_cls, sp) and issubclass(q_cls, sq)]
    if not matches:
        raise NotImplementedError(
            f"KL divergence not registered for ({p_cls.__name__}, "
            f"{q_cls.__name__})")

    # the most specific: minimal in the subclass order
    def _le(a, b):
        return issubclass(a[0], b[0]) and issubclass(a[1], b[1])

    best = matches[0]
    for m in matches[1:]:
        if _le(m, best):
            best = m
    return _REGISTRY[best]


def kl_divergence(p, q):
    return _dispatch(type(p), type(q))(p, q)


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    pl, ps, ql, qs = p.loc, p.scale, q.loc, q.scale
    return (torch.log(qs / ps) + (ps * ps + (pl - ql) ** 2) / (2 * qs * qs)
            - 0.5)


@register_kl(LogNormal, LogNormal)
def _kl_lognormal_lognormal(p, q):
    return _kl_normal_normal(p._base, q._base)


@register_kl(Uniform, Uniform)
def _kl_uniform_uniform(p, q):
    pa, pb, qa, qb = p.low, p.high, q.low, q.high
    kl = torch.log((qb - qa) / (pb - pa))
    return torch.where((qa <= pa) & (pb <= qb), kl,
                       torch.full_like(kl, float("inf")))


@register_kl(Laplace, Laplace)
def _kl_laplace_laplace(p, q):
    pl, ps, ql, qs = p.loc, p.scale, q.loc, q.scale
    scale_ratio = ps / qs
    t = torch.abs(pl - ql) / qs
    return (-torch.log(scale_ratio)
            + scale_ratio * torch.exp(-torch.abs(pl - ql) / ps) + t - 1)


@register_kl(Exponential, Exponential)
def _kl_exponential_exponential(p, q):
    pr, qr = p.rate, q.rate
    return torch.log(pr / qr) + qr / pr - 1


@register_kl(Categorical, Categorical)
def _kl_categorical_categorical(p, q):
    plog = torch.log_softmax(p.logits, -1)
    qlog = torch.log_softmax(q.logits, -1)
    return torch.sum(torch.exp(plog) * (plog - qlog), -1)


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli_bernoulli(p, q):
    eps = 1e-7
    pp = torch.clamp(p.probs, eps, 1 - eps)
    qp = torch.clamp(q.probs, eps, 1 - eps)
    return pp * torch.log(pp / qp) + (1 - pp) * torch.log((1 - pp) / (1 - qp))


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    pa, pb, qa, qb = p.alpha, p.beta, q.alpha, q.beta
    lg, dg = torch.lgamma, torch.digamma
    lbeta_p = lg(pa) + lg(pb) - lg(pa + pb)
    lbeta_q = lg(qa) + lg(qb) - lg(qa + qb)
    return (lbeta_q - lbeta_p + (pa - qa) * dg(pa) + (pb - qb) * dg(pb)
            + (qa - pa + qb - pb) * dg(pa + pb))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet_dirichlet(p, q):
    pc, qc = p.concentration, q.concentration
    lg, dg = torch.lgamma, torch.digamma
    p0 = pc.sum(-1)
    q0 = qc.sum(-1)
    return (lg(p0) - lg(q0) + torch.sum(lg(qc) - lg(pc), -1)
            + torch.sum((pc - qc) * (dg(pc) - dg(p0)[..., None]), -1))


@register_kl(Gumbel, Gumbel)
def _kl_gumbel_gumbel(p, q):
    # Gamma'(1) = -Euler's constant
    euler = 0.57721566490153286060
    pl, ps, ql, qs = p.loc, p.scale, q.loc, q.scale
    r = ps / qs
    return (torch.log(qs / ps) + euler * (r - 1)
            + torch.exp((ql - pl) / qs + torch.lgamma(r + 1))
            + (pl - ql) / qs - 1)


@register_kl(Independent, Independent)
def _kl_independent_independent(p, q):
    if p.reinterpreted_batch_rank != q.reinterpreted_batch_rank:
        raise NotImplementedError("mismatched reinterpreted_batch_rank")
    return _sum_rightmost(kl_divergence(p.base, q.base),
                          p.reinterpreted_batch_rank)


@register_kl(ExponentialFamily, ExponentialFamily)
def _kl_expfamily_expfamily(p, q):
    """The Bregman divergence of the log-normalizers, the gradient on the
    natural parameters by autograd."""
    if type(p) is not type(q):
        raise NotImplementedError(
            f"generic expfamily KL needs matching families, got "
            f"({type(p).__name__}, {type(q).__name__})")
    pn, qn = list(p._natural_parameters), list(q._natural_parameters)
    with torch.enable_grad():
        pg = _with_grad(pn)
        grads = torch.autograd.grad(p._log_normalizer(*pg).sum(), pg,
                                    create_graph=True)
        kl = q._log_normalizer(*qn) - p._log_normalizer(*pg)
        for pa, qa, g in zip(pg, qn, grads):
            term = (pa - qa) * g
            extra = term.dim() - kl.dim()
            if extra > 0:
                term = term.sum(dim=tuple(range(-extra, 0)))
            kl = kl + term
    if not any(t.requires_grad for t in pn + qn):
        kl = kl.detach()
    return kl
