"""A/B of the 1x1 sharded paths of two source trees on one card.

    python3 scripts/ab_sharded.py TREE

TREE is a checkout's root (``.``, or another commit unpacked with ``git
archive`` into a directory git ignores, such as ``build/``): its
``chip_smoke.py`` builds its kernels, runs ``phase_sharded_train`` (the
16-layer deepseek-7b step unsharded and on a 1x1 NCCL mesh), then serves
the main requests through the static engine unsharded and on the mesh,
twice each after a short warm-up. Prints one line ``AB {...}``: the last
training steps' seconds and each engine's tokens/s by run. Run the trees
in turns in one call (parent, this, this, parent) to compare them."""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as c
c._port()
import numpy as np, torch
c.phase_device()
st = c.phase_sharded_train()
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve import Request, ServeEngine
cfg, lm, params = c.build_main_model()
mesh = make_local_mesh(1, 1)
out = {"tree": root, "train_step_s": {k: st["runs"][k]["records"][-1]["step_s"] for k in st["runs"]}}
for name, kw in (("static", {}), ("static_1x1", {"mesh": mesh})):
    eng = ServeEngine(lm, params, scheduler="static", batch_size=8, max_len=1024, device="cuda", **kw)
    rng = np.random.default_rng(98)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32), max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    walls = []
    for _ in range(2):
        t0 = time.perf_counter(); res = eng.generate(c._main_requests(cfg.vocab)); torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    toks = sum(r.steps for r in res)
    out[name] = {"tokens_per_s": [toks / w for w in walls]}
    del eng; torch.cuda.empty_cache()
print("AB " + json.dumps(out))
torch.distributed.destroy_process_group()
