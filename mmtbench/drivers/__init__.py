"""Drivers of the program's entries, one module per kind of traffic mix
(``traffic/<mix>.json`` names its ``driver``): each has a ``Session`` with
``setup``, ``window``, ``trace``, ``release`` and ``check``."""
