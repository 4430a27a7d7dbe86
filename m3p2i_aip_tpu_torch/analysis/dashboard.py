"""Live run dashboard — dependency-free replacement for the reference's
dash "battery level" server (``plot/plot_class.py:10-58``, port 8040).

Port of ``m3p2i_aip_tpu/analysis/dashboard.py`` (stdlib only, the same page
and ``/metrics`` JSON).

A background ``http.server`` thread serves an auto-refreshing HTML page that
renders whatever metrics the running loop publishes (battery level for
parity, plus planner Hz / task / goal distance).  Metrics are published by
writing a CSV exactly like the reference (``data_battery.csv``) or by calling
:meth:`Dashboard.publish` from the control loop.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!DOCTYPE html>
<html><head><title>m3p2i-aip-tpu dashboard</title>
<meta http-equiv="refresh" content="1">
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 .bar-outer {{ width: 400px; height: 30px; border: 1px solid #333; }}
 .bar-inner {{ height: 100%; background: {color}; width: {battery}%; }}
 table {{ border-collapse: collapse; margin-top: 1em; }}
 td, th {{ border: 1px solid #999; padding: 4px 12px; text-align: left; }}
</style></head><body>
<h1>Battery Level of Robot</h1>
<div class="bar-outer"><div class="bar-inner"></div></div>
<p>{battery:.1f}%</p>
<table>
<tr><th>metric</th><th>value</th></tr>
{rows}
</table>
</body></html>
"""


class Dashboard:
    """Serve live metrics on http://localhost:<port> (default 8040)."""

    def __init__(
        self,
        port: int = 8040,
        battery_csv: Optional[str] = None,
        host: str = "127.0.0.1",
    ):
        self.port = port
        self.host = host
        self.battery_csv = battery_csv
        self._metrics = {"battery": 100.0}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        if battery_csv:
            os.makedirs(os.path.dirname(battery_csv) or ".", exist_ok=True)
            with open(battery_csv, "w") as f:
                f.write("100.0\n")

    # ------------------------------------------------------------- publish
    def publish(self, **metrics) -> None:
        with self._lock:
            self._metrics.update(metrics)

    def _battery(self) -> float:
        if self.battery_csv and os.path.exists(self.battery_csv):
            try:
                with open(self.battery_csv) as f:
                    return float(f.read().split()[0])
            except (ValueError, IndexError):
                pass
        return float(self._metrics.get("battery", 100.0))

    # --------------------------------------------------------------- serve
    def start(self) -> "Dashboard":
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence request logging
                pass

            def do_GET(self):
                battery = dash._battery()
                color = (
                    "green" if battery > 80 else "blue" if battery > 60 else "red"
                )
                with dash._lock:
                    metrics = dict(dash._metrics)
                if self.path == "/metrics":
                    body = json.dumps(dict(metrics, battery=battery)).encode()
                    ctype = "application/json"
                else:
                    rows = "\n".join(
                        f"<tr><td>{k}</td><td>{v}</td></tr>"
                        for k, v in sorted(metrics.items())
                    )
                    body = _PAGE.format(
                        battery=battery, color=color, rows=rows
                    ).encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def start_dash_server(port: int = 8040, battery_csv: Optional[str] = None) -> Dashboard:
    """Parity entry point (plot_class.start_dash_server:10-58)."""
    return Dashboard(port=port, battery_csv=battery_csv).start()
