"""One-off measurements of the benchmark: the control's readings and the
daemon's knee.  The benchmark's own runs do not use them."""
