"""Cost accounting of the port: counted work, device times and roofline
terms (`cost`), roofline attribution (`roofline`), and the dry-run's
dispatch-level count of a whole step (`dispatch_cost`, the counterpart of
`repro.analysis.hlo`)."""
