"""Cost accounting of the port: counted work, device times and roofline
terms (`cost`), and roofline attribution (`roofline`)."""
