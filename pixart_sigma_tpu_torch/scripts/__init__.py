"""Entry points run as modules: `serve` (HTTP server with micro-batching) and
`inference` (a prompt file to images)."""
