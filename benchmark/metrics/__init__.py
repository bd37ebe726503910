"""Per-layer metric readers, one a file named after its metric, each with
``read(ctx)`` returning the metric's value or None where the traced run
holds nothing to read. ``ctx`` (the loop's ``layer_context``): the trace's
``events``, ``window_ms`` (CUDA events over the traced stretch), ``units``
(steps or frames traced), ``records`` (the reference's work records of the
frames the traced units ran) over ``records_units`` of them, ``train``,
``device``, and for serving ``host_prep_ms``."""
