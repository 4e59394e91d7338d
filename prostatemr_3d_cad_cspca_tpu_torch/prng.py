"""Random bits of the port: explicit ``torch.Generator``s in the roles of the
JAX package's PRNG keys.

A JAX key is a value and a ``torch.Generator`` is a stream that advances as
it is drawn from. The port treats a generator's seed as its key:
:func:`fold_in` returns a new generator on the parent's device whose seed is
a fixed function of the parent's seed and an integer, so the same parent and
index give the same bits whatever was drawn from the parent before. The bits
differ from JAX's for the same seed; the tests hand both packages the same
keep-masks and latents instead.

``rng`` arguments of the port take a generator, an int seed, None, or a
mapping (a replay of given draws, which draws nothing). One forward draws
from one generator in a fixed order, the order in which the forward reaches
each draw:

  * a network's trunk: its dropout sites ``drope1``-``drope4``, then
    ``dropd3``-``dropd0``, each a uniform tensor of the activation's shape;
  * a ladder pass (probabilistic models): for each level i = 0..3 the
    latent noise ``eps`` (a standard normal of the latent's shape, fp32)
    where the level samples its latent, then the level's dropout site
    ``dropp_i``;
  * a probabilistic ``M1Net``: the passes q_sample, q_mean, p_sample,
    p_sample_z_q, p_sample_z_q_mean in turn; with fused passes each
    network's trunk runs once, just before its first pass's ladder (the
    posterior's before q_sample, the prior's before p_sample), else every
    pass runs its own trunk before its ladder; the detect head runs only
    the passes it needs, in that order (p_sample; for a cascade's stage 1
    q_mean, p_sample, p_sample_z_q_mean);
  * a cascade: stage 1's forward, then stage 2's.

Sites that are inactive (rate 0, or 'standard' dropout at inference) draw
nothing. Each draw is fp32: a uniform in [0, 1) of the activation's shape
(the keep-mask is ``u < 1 - rate``), or a standard normal ``eps`` of the
latent's (the latent is ``loc + scale * eps`` in the location's dtype).

:class:`Draws` hands a forward those draws as given tensors in place of a
generator's (an exported program takes them as inputs, ``export.py``):
each call takes the next draw, and ``fold_in(draws, i)`` descends into the
child's own draws, so one forward of a TTA view, an ensemble member or a
sliding-window chunk takes what ``fold_in(rng, i)`` would have drawn.
:class:`DrawRecorder` draws from a generator as the live forward does and
notes each draw's fold path, site, kind, shape and dtype: the draw plan
that :func:`plan_draws` redraws from a generator bit for bit.

A mapping replays a forward: it maps a site path to its keep-mask
and a latent path to its latent. Paths join scope names with '/': the
scopes are ``stage1``/``stage2`` in a cascade, then in a probabilistic net
``prior``/``posterior`` for a fused trunk and the pass name (``q_sample``
...) for a ladder and an unfused trunk; the leaf is the site (``drope1``,
``dropp_2``) or ``z_<level>`` for the latent a sampling level draws. A
single-stage deterministic net's sites sit at the root (``drope1``).

Data parallelism. :func:`rows` gives each shard of a global batch its rows
of the draws made for the whole batch: a generator's draws are made once,
at the global shape, and sliced (:class:`RowSource` behind a
:class:`Draws`); a mapping's entries are sliced (:class:`Rows`). Every draw
has the batch on its leading axis, so the shards of one forward draw the
one-device forward's bits; :func:`repeat_rows` follows ``infer.
mc_predict``'s sample-major stacking.

Augmentation (``augment``). ``augment_batch`` draws every value from its
generator in one fixed order, for the whole batch at once: one uniform
block of shape (B, 22 + 2 n_img_ch) whose columns are
``augment.UNIFORM_COLUMNS`` and then ``gamma_channel`` and
``poor_channel``, then (when noise is on) the standard normal ``noise`` of
shape (B, D, H, W, n_img_ch). An augmented train step augments with
:func:`augment_rng` of its ``rng``: ``fold_in(rng, AUGMENT_FOLD)``; the
forward keeps drawing from ``rng`` itself, so a step without
``augment_params`` draws the same bits as before augmentation existed. A
mapping replays the augmentation under ``augment/``, each entry with a
leading batch axis: the uniforms of the gates ``master``, ``zoom_on``,
``flip_on``, ``rot_on``, ``trans_on``, ``cs_on``, ``gamma_on``,
``poor_on``, ``noise_on`` (a gate applies at ``> 1 - prob``, ``> tx_prob``
or, for the flip, ``> 0.5``), then ``zoom_scale`` (int), ``rot_angle``,
``trans_pads`` (top, bottom, right, left), ``cs_pads``, ``cs_channel``,
``gamma``, ``gamma_channel`` and ``poor_channel`` (B x n_img_ch uniforms,
a channel's coin applies at ``> 0.5``), ``noise_std`` and ``noise``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Sequence

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def fresh(device) -> torch.Generator:
    """A generator with a seed drawn from numpy's global state, as the JAX
    package self-keys with ``np.random.randint(0, 2**31 - 1)``."""
    return generator(np.random.randint(0, 2 ** 31 - 1), device)


def is_mask_map(rng: Any) -> bool:
    return isinstance(rng, Mapping)


class Scoped(Mapping):
    """The entries of ``base`` under ``prefix`` + '/', with the prefix
    dropped: what one scope of a forward replays."""

    def __init__(self, base: Mapping, prefix: str):
        self.base, self.prefix = base, prefix + "/"

    def __getitem__(self, key):
        return self.base[self.prefix + key]

    def __iter__(self):
        n = len(self.prefix)
        return (k[n:] for k in self.base if k.startswith(self.prefix))

    def __len__(self):
        return sum(1 for _ in self)


def scope(rng: Any, name: str):
    """``rng`` for the part of a forward named ``name``: a mapping's entries
    under ``name/``; :class:`Draws` naming its sites under ``name/``; a
    generator or None as it is (the draws' order keeps the parts apart)."""
    if is_mask_map(rng):
        return Scoped(rng, name)
    if isinstance(rng, Draws):
        return Draws(rng.source, rng.path, rng.prefix + name + "/")
    return rng


def as_rng(rng: Any, device):
    """Normalize an ``rng`` argument: None and mappings pass through, an int
    becomes a generator on ``device``, a generator must live there."""
    if rng is None or is_mask_map(rng) or isinstance(rng, Draws):
        return rng
    if isinstance(rng, (int, np.integer)):
        return generator(int(rng), device)
    if isinstance(rng, torch.Generator):
        if rng.device.type != torch.device(device).type:
            raise ValueError(f"rng is a generator on {rng.device}, the tensors "
                             f"live on {device}")
        return rng
    raise TypeError(f"rng must be None, an int, a torch.Generator or a mapping "
                    f"of keep-masks and latents, got {type(rng).__name__}")


AUGMENT_FOLD = 1 << 20  # the augmentation's child of a train step's rng


def augment_rng(rng):
    """What an augmented train step augments with: a mapping's entries under
    ``augment/``, or ``fold_in(rng, AUGMENT_FOLD)`` of a generator."""
    if is_mask_map(rng):
        return Scoped(rng, "augment")
    if rng is None:
        raise ValueError("an augmented train step needs rng: a torch.Generator, an int "
                         "seed or a mapping of replayed draws")
    return fold_in(rng, AUGMENT_FOLD)


def fold_in(rng, data: int):
    """A child generator (JAX's ``fold_in``): its seed is a fixed function of
    ``rng``'s seed and ``data``. Of :class:`Draws`, the child's own draws."""
    if is_mask_map(rng):
        raise TypeError("a mapping of keep-masks replays one forward; it cannot "
                        "be folded into per-view, per-member or per-chunk streams")
    if isinstance(rng, Draws):
        return Draws(rng.source, rng.path + (int(data),), rng.prefix)
    state = np.random.SeedSequence([int(rng.initial_seed()), int(data)]
                                   ).generate_state(2, np.uint32)
    seed = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=rng.device).manual_seed(seed)


# ------------------------------------------------------- draws as tensors
class Draws:
    """An ``rng`` whose draws are given tensors: ``source.take(path, kind,
    site, shape, device)`` returns each in the forward's order. ``path`` is
    the fold path (the ``fold_in`` data from the root, e.g. view, member),
    ``prefix`` the scope of the sites (``stage1/p_sample/``)."""

    def __init__(self, source, path=(), prefix: str = ""):
        self.source, self.path, self.prefix = source, tuple(path), prefix

    def take(self, kind: str, shape, device, site: str) -> torch.Tensor:
        return self.source.take(self.path, kind, self.prefix + site, tuple(shape), device)


def _draw(gen: torch.Generator, kind: str, shape, device) -> torch.Tensor:
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


def uniform(rng, shape, device, site: str) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of ``shape`` from a generator or :class:`Draws`."""
    if isinstance(rng, Draws):
        return rng.take("uniform", shape, device, site)
    return _draw(rng, "uniform", shape, device)


def normal(rng, shape, device, site: str) -> torch.Tensor:
    """fp32 standard normals of ``shape`` from a generator or :class:`Draws`."""
    if isinstance(rng, Draws):
        return rng.take("normal", shape, device, site)
    return _draw(rng, "normal", shape, device)


class _Streams:
    """One generator a fold path, made from ``rng`` by ``fold_in`` down the
    path at its first draw and drawn from in turn after it."""

    def __init__(self, rng: torch.Generator):
        self.rng, self.gens = rng, {}

    def __call__(self, path) -> torch.Generator:
        if path not in self.gens:
            gen = self.rng
            for data in path:
                gen = fold_in(gen, data)
            self.gens[path] = gen
        return self.gens[path]


class DrawRecorder:
    """A draw source that draws from ``rng`` what a live forward would (the
    same generators in the same order) and records the ``plan`` (per draw
    its ``path``, ``site``, ``kind``, ``shape`` and ``dtype``) and the
    ``draws``."""

    def __init__(self, rng: torch.Generator):
        self.streams, self.plan, self.draws = _Streams(rng), [], []

    def take(self, path, kind, site, shape, device):
        self.plan.append(dict(path=list(path), site=site, kind=kind,
                              shape=[int(d) for d in shape], dtype="float32"))
        self.draws.append(_draw(self.streams(tuple(path)), kind, shape, device))
        return self.draws[-1]


class DrawReplay:
    """A draw source that returns ``draws`` in the order of ``plan`` and
    raises where the forward asks for another draw than the plan's."""

    def __init__(self, plan, draws):
        if len(plan) != len(draws):
            raise ValueError(f"{len(draws)} draws for a plan of {len(plan)}")
        self.plan, self.draws, self.next = plan, list(draws), 0

    def take(self, path, kind, site, shape, device):
        i = self.next
        if i >= len(self.plan):
            raise ValueError(f"the forward draws more than the plan's {len(self.plan)}")
        entry = self.plan[i]
        if (tuple(entry["path"]), entry["kind"], entry["site"]) != (tuple(path), kind, site):
            raise ValueError(f"draw {i} is {entry['kind']} {entry['site']} at "
                             f"{entry['path']}, the forward asks {kind} {site} at {list(path)}")
        self.next += 1
        return self.draws[i]


def plan_draws(plan, rng: torch.Generator, shapes) -> list:
    """The draws of ``plan`` from ``rng`` (a generator on their device),
    bit for bit what the live forward draws from it: each path's generator
    is ``fold_in`` of ``rng`` down the path, drawn from in the plan's order.
    ``shapes[i]`` is draw i's shape at this call's batch."""
    streams = _Streams(rng)
    return [_draw(streams(tuple(e["path"])), e["kind"], shape, rng.device)
            for e, shape in zip(plan, shapes)]


# ------------------------------------------------- rows of a global batch
class Rows(Mapping):
    """The rows ``index`` (along the leading batch axis) of each entry of a
    mapping of replayed draws made for a global batch: what one shard of a
    data-parallel batch replays."""

    def __init__(self, base: Mapping, index: Sequence[int], total: int):
        self.base, self.index, self.total = base, tuple(int(i) for i in index), int(total)

    def __getitem__(self, key):
        v = self.base[key]
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if t.dim() == 0 or t.shape[0] != self.total:
            raise ValueError(f"replayed draw {key!r} has shape {tuple(t.shape)}, not a "
                             f"leading batch of {self.total}")
        return t[torch.as_tensor(self.index, device=t.device)]

    def __iter__(self):
        return iter(self.base)

    def __len__(self):
        return len(self.base)


class _SharedDraws:
    """Each draw of a forward made once for the global batch, on the first
    shard that asks for it, and handed to the others: the n-th draw on a fold
    path is the same tensor for every shard (the shards of one process run
    one after another and each walks the forward's draws in order)."""

    def __init__(self, rng: torch.Generator):
        self.streams, self.device = _Streams(rng), rng.device
        self.made = {}  # path -> [(kind, site, shape, tensor)]

    def get(self, path, i, kind, site, shape):
        made = self.made.setdefault(path, [])
        if i < len(made):
            got = made[i]
            if got[:3] != (kind, site, shape):
                raise ValueError(f"shards disagree on draw {i} at {list(path)}: "
                                 f"{got[:3]} vs {(kind, site, shape)}")
            return got[3]
        if i != len(made):
            raise ValueError(f"draw {i} at {list(path)} asked before draw {len(made)}")
        t = _draw(self.streams(path), kind, shape, self.device)
        made.append((kind, site, shape, t))
        return t


class RowSource:
    """A draw source (``Draws.take``) that gives one shard its rows of each
    draw made for the global batch: rows ``index`` of a draw of leading size
    ``total``, moved to the shard's device."""

    def __init__(self, shared: _SharedDraws, index: Sequence[int], total: int):
        self.shared, self.index, self.total = shared, tuple(int(i) for i in index), int(total)
        self.count = {}

    def take(self, path, kind, site, shape, device):
        if not shape or shape[0] != len(self.index):
            raise ValueError(f"draw {site!r} of shape {tuple(shape)} on a shard of "
                             f"{len(self.index)} rows")
        i = self.count.get(path, 0)
        self.count[path] = i + 1
        full = self.shared.get(tuple(path), i, kind, site, (self.total, *shape[1:]))
        return full[torch.as_tensor(self.index, device=full.device)].to(device)


def rows(rng, shards: Sequence[Sequence[int]], total: int) -> list:
    """One ``rng`` a shard of a global batch of ``total`` rows, shard i
    holding rows ``shards[i]``: each shard's draws are its rows of what
    ``rng`` draws for the whole batch, so the shards together draw the bits
    of one forward over the global batch. None passes through; a mapping
    gives each shard its rows of every entry; a generator is drawn once for
    the global batch (by the first shard to ask, on the generator's device)
    and sliced for each shard (a ``Draws`` of a ``RowSource``)."""
    if rng is None:
        return [None] * len(shards)
    if is_mask_map(rng):
        return [Rows(rng, idx, total) for idx in shards]
    if not isinstance(rng, torch.Generator):
        raise TypeError(f"rows: rng must be None, a torch.Generator or a mapping, "
                        f"got {type(rng).__name__}")
    shared = _SharedDraws(rng)
    return [Draws(RowSource(shared, idx, total)) for idx in shards]


def repeat_rows(rng, n: int):
    """``rng`` for a batch stacked ``n`` times (sample-major, rows ``s*B +
    b``, as ``infer.mc_predict`` stacks its samples): a shard's rows ``b``
    of a global batch of B become rows ``s*B + b`` of n*B. Anything but a
    shard's rows passes through."""
    if isinstance(rng, Rows):
        return Rows(rng.base, [s * rng.total + i for s in range(n) for i in rng.index],
                    n * rng.total)
    if isinstance(rng, Draws) and isinstance(rng.source, RowSource):
        src = rng.source
        grown = RowSource(src.shared, [s * src.total + i for s in range(n) for i in src.index],
                          n * src.total)
        return Draws(grown, rng.path, rng.prefix)
    return rng
