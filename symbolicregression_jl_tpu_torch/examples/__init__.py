"""Runnable walkthroughs of the user flows, one module each (the JAX
package's ``examples/`` on the port): ``python -m
symbolicregression_jl_tpu_torch.examples.<name>``. Each ``main()`` takes the
same arguments as the JAX package's script plus ``device`` (None: the
CUDA card; ``"cpu"`` runs the same search on the CPU), builds the same
data from the same numpy seed and the same ``Options``, and prints the
same marker lines. README.md lists them."""

EXAMPLES = ("quickstart", "custom_initial_population", "llm_in_the_loop",
            "template_expression", "parametric_expression", "dimensional_analysis",
            "recorder_genealogy", "multi_device")
