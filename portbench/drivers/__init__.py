"""One driver module per entry kind (a traffic file's ``kind``), which
declares ``CHECKS``, the numbers that a cell of its kind compares (the
names in ``cells/<cell>.json``'s limits). A driver is
``Driver(cell, seed, device)``: its constructor is the set-up; ``unit(k)``
runs the window's k-th unit; ``finish()`` waits for the device;
``e2e(units, seconds)`` gives its end-to-end metrics; ``work()`` what the
per-layer readers count; ``attempted`` and ``failed``; ``measure()``
frees the program and compares its outputs with the plain reference:
{name: number}, of which the cell's limits name those compared. A driver
over several cards also gives ``memory_peak_bytes()``, the fullest
card's peak; a module with a planted fault of its own names it
``FAULT``, which ``Driver(..., fault=FAULT)`` plants (``calibrate.py``'s
``--fault_seeds``). The model is always the configuration's architecture
(``models/<backbone>.py``)."""
