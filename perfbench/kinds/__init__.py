"""The kinds of traffic mix, one module each (see ``perfbench.drive``)."""
