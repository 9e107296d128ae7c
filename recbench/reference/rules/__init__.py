"""The optimizer rules a configuration may state, one module a rule, found
by the rule's name (``optimizer.tables.rule``, ``optimizer.tower.rule``).
Each module gives:

* ``OPS``: the operations an update takes a param value;
* ``state_per_value(per_element, width)``: f32 state values a param value
  (``per_element``: the leaf keeps its state an element);
* ``init(p, per_element)`` and ``update(p, g, state, hp, step,
  per_element)``: the reference's state and its update of ``p`` in place
  (``hp``: the configuration's entry for the rule, ``step`` from 1;
  ``per_element``: a bool a row of a 2-D ``p``);
* ``first_grad_sq(state, hp, shape)``: the sum of squares of a leaf's
  first gradient, from the state that this rule leaves after one step
  (the program's, by the names that the program gives it), for a leaf of
  ``shape``.

A new rule is a new module here; the program's optimizer takes the same
entry as its param group (``port.make_trainer``).
"""

import importlib


def load(name: str):
    return importlib.import_module(f"recbench.reference.rules.{name}")
