"""Per-layer metric readers, one module per metric base name: the module
``<base>.py`` reads ``<base>.<variant>`` from a traced stretch
(``mmtbench.trace.Trace``) through ``read(trace, shape)``, which returns
{"value": ..., ...} or None when the trace holds nothing to read."""
