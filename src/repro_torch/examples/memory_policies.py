"""Memory-policy walkthrough (the paper's Fig. 4 in miniature).

16 copies of an FFT-like function, each needing 1.5 GB of device memory,
oversubscribe a 16 GB device by 50%. Compare the four placement policies
from §4.3 / Fig. 4:

  ondemand       page-in on first touch, on the critical path (stock UVM)
  madvise        placement hints only: pure overhead, no movement
  prefetch       async upload on queue activation; no proactive reclaim
  prefetch_swap  async upload + async LRU swap-out (the paper's default)

Run:  PYTHONPATH=src python -m repro_torch.examples.memory_policies
"""
from __future__ import annotations

from repro_torch.server import ServerConfig, make_server
from repro_torch.workloads.spec import PAPER_FUNCTIONS
from repro_torch.workloads.traces import TraceEvent


def main() -> None:
    base = PAPER_FUNCTIONS["fft"]
    fns = {f"fft-{i:02d}": base.with_id(f"fft-{i:02d}") for i in range(16)}

    # each copy invoked 20 times sequentially (paper §5.2 setup)
    trace, t = [], 0.0
    for rep in range(20):
        for fid in fns:
            trace.append(TraceEvent(t, fid))
            t += base.warm_time * 0.6       # mild overlap -> queueing

    print(f"{len(fns)} functions x 20 invocations, "
          f"working set {sum(f.mem_bytes for f in fns.values())/2**30:.1f} GB "
          f"on a 16 GB device (50% oversubscribed)\n")
    print(f"{'policy':15s} {'mean lat (s)':>12s} {'mean exec (s)':>13s} "
          f"{'overhead%':>10s}")
    rows = {}
    for pol in ("ondemand", "madvise", "prefetch", "prefetch_swap"):
        cfg = ServerConfig(policy="mqfq-sticky",
                           policy_kwargs=dict(T=10.0, alpha=2.0),
                           n_devices=1, d=2, mem_policy=pol, pool_size=32)
        res = make_server(cfg, fns=fns).run_trace(trace)
        execs = [i.service_time for i in res.invocations if i.done]
        mean_exec = sum(execs) / len(execs)
        rows[pol] = mean_exec
        print(f"{pol:15s} {res.mean_latency():12.2f} {mean_exec:13.3f} "
              f"{100 * (mean_exec / base.warm_time - 1):9.1f}%")

    assert rows["prefetch_swap"] < rows["ondemand"], \
        "Prefetch+Swap must beat stock on-demand paging (Fig. 4)"
    assert rows["madvise"] >= rows["ondemand"] * 0.99, \
        "madvise should not beat on-demand (Fig. 4)"
    print("\nmemory_policies: OK (Prefetch+Swap ~ ideal, as in Fig. 4)")


if __name__ == "__main__":
    main()
