"""Interactive web viewer: train-while-you-look, in the browser.

The browser counterpart of the reference's ImGui window
(``src/testbed.cu:1003-2743``) — see ``ngp_tpu/utils/viewer.py``.

    python scripts/viewer.py data/nerf/fox --port 8080
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("scene")
    p.add_argument("--mode", default=None,
                   choices=["nerf", "sdf", "image", "volume"])
    p.add_argument("--network", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--load_snapshot", default=None)
    p.add_argument("--train_steps_per_frame", type=int, default=8)
    args = p.parse_args(argv)

    from ngp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ngp_tpu.testbed import Testbed
    from ngp_tpu.utils.viewer import serve

    kw = {}
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    tb = Testbed(mode=args.mode, scene=args.scene, config=args.network, **kw)
    if args.load_snapshot:
        tb.load_snapshot(args.load_snapshot)
    serve(tb, args.host, args.port, n_train_steps=args.train_steps_per_frame)


if __name__ == "__main__":
    main()
