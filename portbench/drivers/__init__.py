"""One driver module per entry kind (a traffic file's ``kind``). A driver
is ``Driver(cell, seed, device)``: its constructor is the set-up;
``unit(k)`` runs the window's k-th unit; ``finish()`` waits for the device;
``e2e(units, seconds)`` gives its end-to-end metrics; ``work()`` what the
per-layer readers count; ``attempted`` and ``failed``; ``measure()``
frees the program and compares its outputs with the plain reference:
{name: number}, of which the cell's limits name those compared."""
