"""ms a train step of qwen2-0.5B at full width on the card, with the port
under a given checkout: fednl, 8 x 128 tokens, a refresh every 2 steps,
8 steps from seed 0, each step's host ms to a synchronize and its loss.

    python3 tools/ab_train_step.py PARENT_CHECKOUT   # then ., ., PARENT

Run parent, change, change, parent in one call on one card and compare:
the losses must be equal bit for bit where the step's arithmetic did not
change; the first step includes the kernels' first launches.
"""

import json
import sys
import time

sys.path.insert(0, sys.argv[1] + "/src")

import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import build_all  # noqa: E402
from repro_torch.launch.steps import make_optimizer, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

build_all()
dev = torch.device("cuda")
cfg = get_config("qwen2-0.5b")
model = build_model(cfg)
params = model.init_params(torch.Generator(device=dev).manual_seed(0))
opt = make_optimizer("fednl", 1e-3, k_per_block=2048, curvature="fisher")
state = opt.init(params)
step = make_train_step(model, opt, refresh_every=2, n_silos=1)
pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=128, global_batch=8, seed=0)
ms, loss = [], []
for i in range(8):
    b = pipe.batch(i, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, state, m = step(params, state, b)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
    loss.append(float(m["loss"]))
print(json.dumps({"side": sys.argv[1], "ms": ms, "loss": loss}), flush=True)
