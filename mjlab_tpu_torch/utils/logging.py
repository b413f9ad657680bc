"""Plain-text tables: `render_table`, copied from mjlab_tpu/utils/logging.py
so that the port imports nothing of the JAX package (the reference's
utils/logging.py, with the table rendering in place of prettytable). The
JAX file's `print_info` is left out: nothing in either package calls it."""

from __future__ import annotations


def render_table(title: str, headers: list[str], rows: list[list]) -> str:
  """A minimal ASCII table: the title, then the headers and rows framed by
  `+---+` separators, each column as wide as its widest cell."""
  cells = [[str(c) for c in row] for row in rows]
  widths = [
    max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
    for i, h in enumerate(headers)
  ]
  sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
  out = [title, sep]
  out.append("|" + "|".join(f" {h:<{w}} " for h, w in zip(headers, widths)) + "|")
  out.append(sep)
  for row in cells:
    out.append("|" + "|".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "|")
  out.append(sep)
  return "\n".join(out)
