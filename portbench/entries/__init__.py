"""The step entries: one module per entry, found by name.  See
``portbench/README.md`` for what a module defines."""
