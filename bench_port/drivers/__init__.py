"""The code that runs each kind of traffic: a mix's `driver` names one.
A driver is made from (cell, seed, device, trace) and has `setup()`,
`window(seconds)`, `profile()`, `release()` and `check()`; its `record`
(`record.Record`) is what the metric readers read."""
