"""Regex-based name resolution (host-side config plumbing); a copy of
mjlab_tpu/core/strings.py, which the port does not import.

Covers the name-matching surface the reference uses from
`utils/string.py` and `third_party/isaaclab/.../string.py:178,274`
(resolve_matching_names / _values, filter_exp, resolve_expr, resolve_field) —
re-implemented with identical matching semantics: full-match for the
Isaac-Lab-style resolvers, prefix match (re.match) for the mjlab-style ones.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, TypeVar

T = TypeVar("T")


def resolve_expr(
  pattern_map: dict[str, T], names: Sequence[str], default_val: T = 0.0
) -> tuple[T, ...]:
  """Per-name values from a {regex: value} map; first matching pattern wins."""
  compiled = [(re.compile(p), v) for p, v in pattern_map.items()]
  out = []
  for name in names:
    for pat, val in compiled:
      if pat.match(name):
        out.append(val)
        break
    else:
      out.append(default_val)
  return tuple(out)


def filter_exp(exprs: Sequence[str], names: Sequence[str]) -> tuple[str, ...]:
  """Subset of names matching any of the regex patterns (order preserved)."""
  compiled = [re.compile(e) for e in exprs]
  return tuple(n for n in names if any(p.match(n) for p in compiled))


def resolve_field(
  field: T | dict[str, T], names: Sequence[str], default_val: T = 0
) -> tuple[T, ...]:
  """Broadcast a scalar or resolve a {regex: value} dict over names."""
  if isinstance(field, dict):
    return resolve_expr(field, names, default_val)
  return tuple([field] * len(names))


def resolve_matching_names(
  keys: str | Sequence[str],
  list_of_strings: Sequence[str],
  preserve_order: bool = False,
) -> tuple[list[int], list[str]]:
  """Match regex keys against strings → (indices, names).

  Default ordering follows the target-string order; `preserve_order=True`
  reorders results by query-key order. Raises if a string matches multiple
  keys or if any key matches nothing.
  """
  idx, names, _ = _match(keys, list_of_strings, None, preserve_order)
  return idx, names


def resolve_matching_names_values(
  data: dict[str, Any],
  list_of_strings: Sequence[str],
  preserve_order: bool = False,
) -> tuple[list[int], list[str], list[Any]]:
  """Like resolve_matching_names but maps each match to its key's value."""
  if not isinstance(data, dict):
    raise TypeError(f"Input argument `data` should be a dictionary: {data}")
  return _match(list(data.keys()), list_of_strings, list(data.values()),
                preserve_order)


def _match(keys, strings, values, preserve_order):
  if isinstance(keys, str):
    keys = [keys]
  hits: list[tuple[int, int]] = []  # (key_index, target_index)
  matched_by: list[str | None] = [None] * len(strings)
  key_hit = [False] * len(keys)
  for ti, s in enumerate(strings):
    for ki, k in enumerate(keys):
      if re.fullmatch(k, s):
        if matched_by[ti] is not None:
          raise ValueError(
            f"Multiple matches for '{s}': '{matched_by[ti]}' and '{k}'!"
          )
        matched_by[ti] = k
        key_hit[ki] = True
        hits.append((ki, ti))
  if not all(key_hit):
    missing = [k for k, h in zip(keys, key_hit) if not h]
    raise ValueError(
      f"Not all regular expressions are matched! Unmatched: {missing}. "
      f"Available strings: {list(strings)}"
    )
  if preserve_order:
    hits.sort(key=lambda kt: (kt[0], kt[1]))
  idx = [ti for _, ti in hits]
  names = [strings[ti] for ti in idx]
  if values is None:
    return idx, names, None
  vals = [values[ki] for ki, _ in hits]
  return idx, names, vals
