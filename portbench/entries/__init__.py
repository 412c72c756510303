"""The calls into the port that a configuration drives, one module per
``entry`` a configuration names. An entry builds the system under test in
``setup`` (warming up every shape the cell's traffic uses), serves one
request per ``run`` call, keeps what the check needs of a sample of them,
and hands the check its records."""
