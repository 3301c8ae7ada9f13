"""The benchmark's plain reference: frozen copies of the port's DFGs,
workload generator and float64 sequential simulator, importing nothing
of the program."""
