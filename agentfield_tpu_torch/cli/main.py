"""`aftpu` — the unified CLI: the port's copy of ``agentfield_tpu/cli/main.py``.

Command surface mirrors the reference's `af` tool (internal/cli/root.go:32:
server|init|install|run|dev|stop|logs|list|mcp|vc|version): `model` runs a
model node on the card (``serving.model_node.build_model_node``), `status`
reads the cluster through the control-plane API. Process management keeps a
pidfile registry under the data dir (reference:
internal/infrastructure/process/manager.go).

`server` runs the port's control plane with its keystore, on a SQLite path
or a ``postgres://`` DSN (``server.db_path``), with the admin gRPC service on
its port + 100; `model` serves HTTP and gRPC ``Generate`` (on its port +
100; a failed bind prints "model gRPC disabled" and serves on) as the JAX
CLI does. Differences from the JAX CLI, each said on stderr where it
applies: `model` serves on the card, or on the CPU with ``--cpu`` or
``AGENTFIELD_MODEL_CPU=1``, and exits non-zero without a CUDA device
otherwise; `vc verify` and `mcp generate` run on the port's
``control_plane/identity.py`` and ``sdk/mcp.py``. `init`'s Python template
imports ``agentfield_tpu_torch.sdk``.

Run as ``python -m agentfield_tpu_torch.cli <command>``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import re
import sys
import time
from pathlib import Path

import agentfield_tpu_torch
from agentfield_tpu_torch.config import Config, load_config

PY = sys.executable


def data_dir(cfg: Config) -> Path:
    d = cfg.expanded_data_dir()
    d.mkdir(parents=True, exist_ok=True)
    (d / "logs").mkdir(exist_ok=True)
    return d


def _registry_path(cfg: Config) -> Path:
    return data_dir(cfg) / "processes.json"


def _load_registry(cfg: Config) -> dict:
    p = _registry_path(cfg)
    return json.loads(p.read_text()) if p.exists() else {}


def _save_registry(cfg: Config, reg: dict) -> None:
    _registry_path(cfg).write_text(json.dumps(reg, indent=2))


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def _spawn(cfg: Config, name: str, argv: list[str], env: dict | None = None) -> int:
    log = data_dir(cfg) / "logs" / f"{name}.log"
    reg = _load_registry(cfg)
    if name in reg and _alive(reg[name]["pid"]):
        print(f"{name} already running (pid {reg[name]['pid']})", file=sys.stderr)
        return 1
    with open(log, "ab") as lf:
        proc = subprocess.Popen(
            argv,
            stdout=lf,
            stderr=subprocess.STDOUT,
            env={**os.environ, **(env or {})},
            start_new_session=True,
        )
    reg[name] = {"pid": proc.pid, "argv": argv, "started_at": time.time(), "log": str(log)}
    _save_registry(cfg, reg)
    print(f"started {name} (pid {proc.pid}, log {log})")
    return 0


# -- commands -----------------------------------------------------------


def cmd_server(cfg: Config, args) -> int:
    if args.detach:
        argv = [PY, "-m", "agentfield_tpu_torch.cli"]
        if args.config:
            argv += ["--config", args.config]
        argv += ["server"]
        if args.port is not None:
            argv += ["--port", str(args.port)]
        return _spawn(cfg, "control-plane", argv)
    from agentfield_tpu_torch.control_plane.server import ControlPlane, run_server

    async def main():
        db = cfg.server.db_path
        if "://" not in db:  # a postgres:// DSN is not a filesystem path
            db = os.path.expanduser(db)
            Path(db).parent.mkdir(parents=True, exist_ok=True)
        port = args.port or cfg.server.port
        cp = ControlPlane(
            db_path=db,
            data_dir=str(data_dir(cfg)),
            keystore_path=str(data_dir(cfg) / "keystore.bin"),
            keystore_passphrase=cfg.server.keystore_passphrase,
            payload_dir=str(data_dir(cfg) / "payloads"),
            admin_grpc_port=port + 100,  # reference convention: admin on port+100
            agent_timeout=cfg.execution.agent_timeout,
            sync_wait_timeout=cfg.execution.sync_wait_timeout,
            async_workers=cfg.execution.async_workers,
            queue_capacity=cfg.execution.queue_capacity,
            heartbeat_ttl=cfg.presence.heartbeat_ttl,
            sweep_interval=cfg.presence.sweep_interval,
            evict_after=cfg.presence.evict_after,
            webhook_secret=cfg.server.webhook_secret,
            cleanup_interval=cfg.execution.cleanup_interval,
            stale_after=cfg.execution.stale_after,
            retention=cfg.execution.retention,
        )
        runner = await run_server(cp, host=cfg.server.host, port=port)
        print(f"control plane on {cfg.server.host}:{port} (admin gRPC :{port + 100}, db={db})",
              flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for s in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(s, stop.set)
        try:
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(main())
    return 0


def cmd_model(cfg: Config, args) -> int:
    name = f"model-{args.name}" if args.name else "model"
    if args.detach:
        argv = [PY, "-m", "agentfield_tpu_torch.cli"]
        if args.config:
            argv += ["--config", args.config]
        argv += ["model", "--model", args.model or cfg.model_node.model]
        if args.checkpoint:
            argv += ["--checkpoint", args.checkpoint]
        if getattr(args, "lora", None):
            argv += ["--lora", args.lora]
        if args.name:
            argv += ["--name", args.name]
        if args.url:
            argv += ["--url", args.url]
        if args.cpu:
            argv += ["--cpu"]
        return _spawn(cfg, name, argv)
    import threading

    from agentfield_tpu_torch.serving import model_node

    if args.cpu or os.environ.get("AGENTFIELD_MODEL_CPU") == "1":
        device = "cpu"
    elif model_node.card_available():
        device = "cuda"
    else:
        print("[aftpu] no CUDA device: the model node serves on the card; pass --cpu "
              "(or AGENTFIELD_MODEL_CPU=1) to serve on the CPU", file=sys.stderr)
        return 1
    from agentfield_tpu_torch.serving.engine import EngineConfig

    mn = cfg.model_node
    if mn.grammar_whitespace:
        print("[aftpu] model_node.grammar_whitespace is not ported: the port's node "
              "decodes canonical compact JSON only", file=sys.stderr)
        return 1
    ecfg = EngineConfig(
        max_batch=mn.max_batch,
        page_size=mn.page_size,
        num_pages=mn.num_pages,
        max_pages_per_seq=mn.max_pages_per_seq,
        attn_impl=mn.attn_impl,
        prefill_impl=mn.prefill_impl,
        prefill_chunk=mn.prefill_chunk,
        decode_span=mn.decode_span,
        kv_quant_dtype=mn.kv_quant_dtype,
        grammar_slots=mn.grammar_slots,
    )
    server, _ = model_node.build_model_node(
        args.model or mn.model,
        ecfg=ecfg,
        device=device,
        node_id=args.name or "model",
        control_plane=args.url or f"http://{cfg.server.host}:{cfg.server.port}",
        checkpoint=args.checkpoint or mn.checkpoint,
        lora=getattr(args, "lora", None) or mn.lora,
        tp=mn.tp,
        tp_backend=("gloo" if device == "cpu" else "nccl") if mn.tp > 1 else None,
        vision=mn.vision,
        audio=mn.audio,
        tts=mn.tts,
        imagegen=mn.imagegen,
        quant=mn.quant,
        spec_draft=mn.spec_draft,
        spec_k=mn.spec_k or None,
    )
    stopping = threading.Event()
    for s in (signal.SIGINT, signal.SIGTERM):
        signal.signal(s, lambda signum, frame: stopping.set())
    port = server.start("127.0.0.1", 0)
    grpc_note = ""
    try:
        grpc_note = f", gRPC :{server.start_grpc(port + 100)}"
    except OSError as e:
        print(f"[aftpu] model gRPC disabled: {e}", file=sys.stderr)
    print(
        f"model node '{server.node_id}' ({args.model or mn.model}) on :{port}{grpc_note} "
        f"({device})",
        flush=True,
    )
    try:
        stopping.wait()
    finally:
        server.stop(float(os.environ.get("AGENTFIELD_DRAIN_GRACE", model_node.DRAIN_GRACE_S)))
    return 0


AGENT_TEMPLATE = '''"""{name} — an agentfield_tpu agent."""

from agentfield_tpu_torch.sdk import Agent

app = Agent("{name}")


@app.reasoner(description="Example reasoner backed by the TPU model node")
async def respond(prompt: str, max_new_tokens: int = 64) -> dict:
    out = await app.ai(prompt=prompt, max_new_tokens=max_new_tokens)
    return {{"text": out.get("text"), "model": out["model"]}}


@app.skill(description="Example deterministic skill")
def word_count(text: str) -> int:
    return len(text.split())


if __name__ == "__main__":
    app.serve()
'''


CPP_AGENT_TEMPLATE = """// {name} — an agentfield_tpu agent (C++ SDK).
// Build: g++ -O2 -std=c++17 -I<repo>/native/sdk -o {name} main.cpp -pthread
#include "afagent.hpp"

int main(int argc, char** argv) {{
    afield::Agent app("{name}", argc > 1 ? argv[1] : "http://127.0.0.1:8800");
    app.register_reasoner("respond", [&app](const std::string& body) {{
        auto prompt = afield::json_scan_string(body, "prompt");
        auto out = app.ai(prompt, /*max_new_tokens=*/64);
        if (!out.ok) throw std::runtime_error(out.error);
        return "{{\\"text\\": \\"" + afield::json_escape(out.text) + "\\"}}";
    }}, "Example reasoner backed by the TPU model node");
    app.start();  // bind + register + heartbeat (returns once registered)
    for (;;) std::this_thread::sleep_for(std::chrono::seconds(60));
    return 0;
}}
"""

GO_AGENT_TEMPLATE = """// {name} — an agentfield_tpu agent (Go SDK, sdk/go).
package main

import (
	context "context"
	agent "agentfield-tpu/sdk/go/agent"
)

func main() {{
	a, err := agent.New("{name}", "http://127.0.0.1:8800")
	if err != nil {{ panic(err) }}
	a.RegisterReasoner("respond", "Example reasoner", func(ctx context.Context, in map[string]any) (any, error) {{
		prompt, _ := in["prompt"].(string)
		out, err := a.Ai(ctx, prompt, nil)
		if err != nil {{ return nil, err }}
		return map[string]any{{"text": out.Text, "model": out.Model}}, nil
	}})
	ctx := context.Background()
	if err := a.Start(ctx); err != nil {{ panic(err) }}
	select {{}}
}}
"""


def cmd_init(cfg: Config, args) -> int:
    """Scaffold an agent project (reference: af init, internal/cli/init.go:202
    — which ships Python AND Go templates, internal/templates/go/). Language
    via --lang: python (default) | cpp (this repo's in-CI second language) |
    go (sources for the toolchain-gated sdk/go)."""
    target = Path(args.name)
    if target.exists():
        print(f"{target} already exists", file=sys.stderr)
        return 1
    lang = getattr(args, "lang", "python")
    target.mkdir(parents=True)
    if lang == "cpp":
        (target / "main.cpp").write_text(CPP_AGENT_TEMPLATE.format(name=args.name))
        entry, created = "main.cpp", "main.cpp"
    elif lang == "go":
        # module paths reject slashes-from-abs-paths/uppercase/spaces —
        # sanitize the basename (the name itself only lands in comments)
        mod = re.sub(r"[^a-z0-9._-]", "-", Path(args.name).name.lower()).strip("-._") or "agent"
        (target / "main.go").write_text(GO_AGENT_TEMPLATE.format(name=target.name))
        # Point the replace directive at the REAL sdk/go when this install
        # has one: a relative ../sdk/go only builds if the project happens to
        # sit next to the repo checkout — everywhere else `go build` dies on
        # a missing module. The absolute path works from any directory.
        sdk_go = Path(__file__).resolve().parents[2] / "sdk" / "go"
        replace_path = str(sdk_go) if (sdk_go / "go.mod").exists() else "../sdk/go"
        (target / "go.mod").write_text(
            f"module {mod}\n\ngo 1.21\n\n"
            "// replace points at the repo checkout holding sdk/go\n"
            "require agentfield-tpu/sdk/go v0.0.0\n"
            f"replace agentfield-tpu/sdk/go => {replace_path}\n"
        )
        entry, created = "main.go", "main.go, go.mod"
    else:
        (target / "main.py").write_text(AGENT_TEMPLATE.format(name=args.name))
        entry, created = "main.py", "main.py"
    (target / "agentfield.yaml").write_text(
        f"name: {args.name}\nentry: {entry}\ndescription: scaffolded by aftpu init\n"
    )
    print(f"created {target}/ ({created}, agentfield.yaml)")
    return 0


def cmd_run(cfg: Config, args) -> int:
    from agentfield_tpu_torch.cli.packages import resolve_entrypoint

    entry = resolve_entrypoint(args.path, data_dir(cfg))
    if entry is None:
        entry = Path(args.path)
        if entry.is_dir():
            entry = entry / "main.py"
    if not entry.exists():
        print(f"no such agent entry or installed package {args.path!r}", file=sys.stderr)
        return 1
    name = args.name or entry.resolve().parent.name
    env = {"AGENTFIELD_URL": args.url} if args.url else {}
    return _spawn(cfg, name, [PY, str(entry)], env=env)


def cmd_install(cfg: Config, args) -> int:
    """Install an agent package from a local path or git source (reference:
    af install, internal/packages/installer.go:186)."""
    from agentfield_tpu_torch.cli.packages import PackageError, install

    try:
        entry = install(args.source, data_dir(cfg), force=args.force)
    except PackageError as e:
        print(f"install failed: {e}", file=sys.stderr)
        return 1
    print(f"installed {entry['name']} -> {entry['path']}")
    return 0


def cmd_uninstall(cfg: Config, args) -> int:
    from agentfield_tpu_torch.cli.packages import uninstall

    if not uninstall(args.name, data_dir(cfg)):
        print(f"unknown package {args.name!r}", file=sys.stderr)
        return 1
    print(f"uninstalled {args.name}")
    return 0


def cmd_packages(cfg: Config, args) -> int:
    from agentfield_tpu_torch.cli.packages import load_registry

    reg = load_registry(data_dir(cfg))
    if not reg:
        print("no installed packages")
        return 0
    for name, e in sorted(reg.items()):
        print(f"{name:24s} {e['origin']['type']:6s} {e['description'][:50]}")
    return 0


def cmd_dev(cfg: Config, args) -> int:
    """Foreground run with restart-on-change (reference: af dev, commands/dev.go:37)."""
    entry = Path(args.path)
    if entry.is_dir():
        entry = entry / "main.py"
    watch_dir = entry.resolve().parent

    def snapshot():
        return {
            p: p.stat().st_mtime for p in watch_dir.rglob("*.py") if p.is_file()
        }

    while True:
        proc = subprocess.Popen([PY, str(entry)], env={**os.environ})
        state = snapshot()
        try:
            while True:
                time.sleep(1.0)
                if proc.poll() is not None:
                    print(f"agent exited ({proc.returncode}); waiting for changes...")
                    while snapshot() == state:
                        time.sleep(1.0)
                    break
                if snapshot() != state:
                    print("change detected; restarting...")
                    _terminate(proc)
                    break
        except KeyboardInterrupt:
            _terminate(proc)
            return 0


def _terminate(proc: subprocess.Popen) -> None:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def cmd_stop(cfg: Config, args) -> int:
    reg = _load_registry(cfg)
    names = [args.name] if args.name else list(reg)
    rc = 0
    for name in names:
        info = reg.get(name)
        if not info:
            print(f"unknown process {name!r}", file=sys.stderr)
            rc = 1
            continue
        if _alive(info["pid"]):
            os.kill(info["pid"], signal.SIGTERM)
            print(f"stopped {name} (pid {info['pid']})")
        else:
            print(f"{name} was not running")
        del reg[name]
    _save_registry(cfg, reg)
    return rc


def cmd_list(cfg: Config, args) -> int:
    reg = _load_registry(cfg)
    if not reg:
        print("no managed processes")
        return 0
    for name, info in sorted(reg.items()):
        state = "running" if _alive(info["pid"]) else "dead"
        print(f"{name:24s} pid={info['pid']:<8d} {state:8s} log={info['log']}")
    return 0


def cmd_logs(cfg: Config, args) -> int:
    reg = _load_registry(cfg)
    info = reg.get(args.name)
    log = Path(info["log"]) if info else data_dir(cfg) / "logs" / f"{args.name}.log"
    if not log.exists():
        print(f"no log for {args.name!r}", file=sys.stderr)
        return 1
    text = log.read_text(errors="replace").splitlines()
    for line in text[-args.tail :]:
        print(line)
    return 0


def cmd_status(cfg: Config, args) -> int:
    """Cluster status via the control-plane API."""
    import urllib.request

    url = args.url or f"http://{cfg.server.host}:{cfg.server.port}"
    try:
        with urllib.request.urlopen(f"{url}/api/v1/nodes", timeout=5) as r:
            nodes = json.loads(r.read())["nodes"]
        with urllib.request.urlopen(f"{url}/api/v1/runs?limit=5", timeout=5) as r:
            runs = json.loads(r.read())["runs"]
    except Exception as e:
        print(f"control plane unreachable at {url}: {e}", file=sys.stderr)
        return 1
    print(f"control plane: {url}  nodes: {len(nodes)}")
    for n in nodes:
        comps = len(n.get("reasoners", [])) + len(n.get("skills", []))
        print(f"  {n['node_id']:24s} {n['kind']:6s} {n['status']:9s} {comps} components")
    if runs:
        print("recent runs:")
        for r_ in runs:
            print(f"  {r_['run_id']:28s} {r_['overall_status']:10s} {r_['executions']} executions")
    return 0


def cmd_vc_verify(cfg: Config, args) -> int:
    """Verify a VC document offline (reference: af vc verify)."""
    from agentfield_tpu_torch.control_plane.identity import VCService

    try:
        doc = json.loads(Path(args.file).read_text())
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot read VC: {e}", file=sys.stderr)
        return 1
    if not isinstance(doc, dict):
        print(f"INVALID: document is {type(doc).__name__}, expected a VC object")
        return 1
    vc = doc.get("vc", doc)  # accept both the API envelope and a bare VC
    if not isinstance(vc, dict):
        print("INVALID: 'vc' field is not an object")
        return 1
    ok, reason = VCService.verify(vc)
    print(f"{'VALID' if ok else 'INVALID'}: {reason}")
    if ok and "credentialSubject" in vc:
        cs = vc["credentialSubject"]
        print(f"  issuer:    {vc.get('issuer')}")
        print(f"  target:    {cs.get('target')}  status: {cs.get('status')}")
        print(f"  execution: {cs.get('execution_id')}  run: {cs.get('run_id')}")
    return 0 if ok else 1


def cmd_mcp_generate(cfg: Config, args) -> int:
    """Generate typed Python skill stubs from an MCP server's tools
    (reference: SkillGenerator.GenerateSkillsForServer, skill_generator.go:37)."""
    from agentfield_tpu_torch.sdk.mcp import MCPManager, generate_skill_file

    spec = MCPManager.discover_config(args.project or ".")
    if args.server not in spec:
        print(
            f"server {args.server!r} not in .mcp.json (known: {sorted(spec)})",
            file=sys.stderr,
        )
        return 1

    async def run():
        mgr = MCPManager({args.server: spec[args.server]})
        await mgr.start_all()
        try:
            tools = mgr.tools[args.server]
            return generate_skill_file(args.server, tools), len(tools)
        finally:
            await mgr.stop_all()

    code, n_tools = asyncio.run(run())
    out = Path(args.project or ".") / f"mcp_{args.server}_skills.py"
    out.write_text(code)
    print(f"wrote {out} ({n_tools} skills)")
    return 0


def cmd_version(cfg: Config, args) -> int:
    print(f"agentfield_tpu_torch {agentfield_tpu_torch.__version__}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aftpu", description=__doc__)
    p.add_argument("--config", help="YAML config file")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("server", help="run the control plane")
    s.add_argument("--port", type=int, default=None)
    s.add_argument("--detach", action="store_true")
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("model", help="run a model node (on the card; --cpu for the CPU)")
    s.add_argument("--model", help="model preset (see models/configs.py)")
    s.add_argument("--checkpoint", help="HF checkpoint dir (safetensors)")
    s.add_argument("--lora", help="LoRA adapter dir (save_adapter) merged at load")
    s.add_argument("--name", help="node id (default: model)")
    s.add_argument("--url", help="control plane URL")
    s.add_argument("--cpu", action="store_true", help="serve on the CPU backend (demo/debug)")
    s.add_argument("--detach", action="store_true")
    s.set_defaults(fn=cmd_model)

    s = sub.add_parser("init", help="scaffold an agent project")
    s.add_argument("name")
    s.add_argument("--lang", choices=("python", "cpp", "go"), default="python",
                   help="template language (default python)")
    s.set_defaults(fn=cmd_init)

    s = sub.add_parser("install", help="install an agent package (local path or git)")
    s.add_argument("source")
    s.add_argument("--force", action="store_true")
    s.set_defaults(fn=cmd_install)

    s = sub.add_parser("uninstall", help="remove an installed package")
    s.add_argument("name")
    s.set_defaults(fn=cmd_uninstall)

    s = sub.add_parser("packages", help="list installed packages")
    s.set_defaults(fn=cmd_packages)

    s = sub.add_parser("run", help="run an agent (installed package name or path)")
    s.add_argument("path")
    s.add_argument("--name")
    s.add_argument("--url", help="control plane URL for the agent")
    s.set_defaults(fn=cmd_run)

    s = sub.add_parser("dev", help="run an agent with restart-on-change")
    s.add_argument("path")
    s.set_defaults(fn=cmd_dev)

    s = sub.add_parser("stop", help="stop managed process(es)")
    s.add_argument("name", nargs="?")
    s.set_defaults(fn=cmd_stop)

    s = sub.add_parser("list", help="list managed processes")
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("logs", help="show a managed process's log")
    s.add_argument("name")
    s.add_argument("--tail", type=int, default=50)
    s.set_defaults(fn=cmd_logs)

    s = sub.add_parser("status", help="cluster status via the control plane")
    s.add_argument("--url")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("vc", help="verifiable-credential tools")
    vc_sub = s.add_subparsers(dest="vc_command", required=True)
    v = vc_sub.add_parser("verify", help="verify a VC JSON document offline")
    v.add_argument("file")
    v.set_defaults(fn=cmd_vc_verify)

    s = sub.add_parser("mcp", help="MCP tools")
    mcp_sub = s.add_subparsers(dest="mcp_command", required=True)
    m = mcp_sub.add_parser("generate", help="generate typed skill stubs from a server's tools")
    m.add_argument("server")
    m.add_argument("--project", help="project dir containing .mcp.json (default .)")
    m.set_defaults(fn=cmd_mcp_generate)

    s = sub.add_parser("version", help="print version")
    s.set_defaults(fn=cmd_version)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    return args.fn(cfg, args)


if __name__ == "__main__":
    sys.exit(main())
