"""MovieLens-shaped ratings made on the device from a seed.

The distribution is the repository's synthetic MovieLens generator
(``chip_smoke.py`` ``synth_ratings(..., distinct=True)``, after
``bench.py``): user activity Zipf(``user_zipf``) over user ids, item
popularity Zipf(``item_zipf``) over item ids, ratings uniform over the
half stars 0.5 .. 5.0, and every (user, item) pair distinct.  A pair
drawn again keeps its place in the draw order and is redrawn, both ends
from the same marginals, until it is new, so the heaviest users and
items fill their whole row.

Here the draws are inverse-CDF lookups of uniform doubles from one
``torch.Generator`` on the device, and the duplicates are found by
sorting the pair keys on the device: the same seed gives the same
ratings on the same device.  Imports only torch.
"""

from __future__ import annotations

import torch

__all__ = ["synth_ratings", "zipf_cdf"]


def zipf_cdf(n: int, exponent: float, device) -> torch.Tensor:
    """Cumulative weights of ``1 / k**exponent`` for k = 1..n, in
    float64, normalised to end at 1."""
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(k.pow(-exponent), 0)
    return cdf / cdf[-1]


def _draw(cdf: torch.Tensor, size: int, gen: torch.Generator) -> torch.Tensor:
    """``size`` ids drawn from the distribution of ``cdf``, int32."""
    r = torch.rand(size, generator=gen, dtype=torch.float64,
                   device=cdf.device)
    ids = torch.searchsorted(cdf, r, right=True)
    return ids.clamp_(max=cdf.numel() - 1).to(torch.int32)


def _is_new(keys_sorted: torch.Tensor, taken: list) -> torch.Tensor:
    """For sorted candidate keys: True where a key is the first of its
    equal run and is in none of the sorted ``taken`` chunks."""
    new = torch.ones_like(keys_sorted, dtype=torch.bool)
    if keys_sorted.numel() > 1:
        new[1:] = keys_sorted[1:] != keys_sorted[:-1]
    for chunk in taken:
        if chunk.numel() == 0:
            continue
        pos = torch.searchsorted(chunk, keys_sorted).clamp_(
            max=chunk.numel() - 1)
        new &= chunk[pos] != keys_sorted
    return new


def synth_ratings(n_users: int, n_items: int, n_ratings: int, seed: int,
                  device, user_zipf: float = 0.8, item_zipf: float = 1.0,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(user ids int32, item ids int32, ratings float32)`` on
    ``device``, ``n_ratings`` distinct pairs, from ``seed``."""
    if n_ratings > n_users * n_items:
        raise ValueError(
            f"{n_ratings} distinct pairs do not fit {n_users} x {n_items}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    cdf_u = zipf_cdf(n_users, user_zipf, device)
    cdf_i = zipf_cdf(n_items, item_zipf, device)
    u = _draw(cdf_u, n_ratings, gen)
    i = _draw(cdf_i, n_ratings, gen)
    v = torch.randint(1, 11, (n_ratings,), generator=gen, device=device,
                      dtype=torch.int32).to(torch.float32) * 0.5
    key = u.to(torch.int64) * n_items + i
    ks, order = torch.sort(key, stable=True)
    first = _is_new(ks, [])
    taken = [ks[first]]
    # the later draws of a taken pair, in draw order
    todo = torch.sort(order[~first]).values
    del key, ks, order, first
    while todo.numel():
        cu = _draw(cdf_u, todo.numel(), gen)
        ci = _draw(cdf_i, todo.numel(), gen)
        cs, o = torch.sort(cu.to(torch.int64) * n_items + ci, stable=True)
        fresh = _is_new(cs, taken)
        ok = torch.zeros(todo.numel(), dtype=torch.bool, device=device)
        ok[o[fresh]] = True
        u[todo[ok]] = cu[ok]
        i[todo[ok]] = ci[ok]
        taken.append(cs[fresh])
        if len(taken) > 4:
            # fold the small chunks into one, so each round searches few
            taken = [taken[0], torch.sort(torch.cat(taken[1:])).values]
        todo = todo[~ok]
    return u, i, v
