"""The benchmark's plain references, importing nothing of the program:
frozen copies of the port's DFGs, workload generator and float64
sequential simulator (numpy), and `lm_ref`, the language-model lane's
float32 forward pass (plain torch)."""
