"""The paper's reproduction and the other benchmarks, on the port.

One module for each benchmark of ``benchmarks/`` (the reference's names kept:
``bench_prediction`` is ``prediction`` here), each with
``main(device="cuda", json_path=None)`` that prints the reference's
``name,us_per_call,derived`` rows and returns them. The derived columns
equal the reference's; the times are the card's, or the CPU's with
``device="cpu"``. ``repro_torch.paper_repro`` runs the paper's figures and
tables; ``repro_torch.paper.run`` runs every benchmark.

Each module's ``MEASURED`` names the derived keys that a run measures
(times, speedups, differences between devices): those vary from run to
run, and every other key is a result that the port must reproduce.
"""
