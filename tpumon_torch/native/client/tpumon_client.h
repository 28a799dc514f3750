/* tpumon_client.h — C client library for the gpu-hostengine agent.
 *
 * Role analog of the reference's Go `dcgm` package (bindings/go/dcgm/):
 * where the reference exposes the daemon to Go programs, this library
 * exposes gpu-hostengine to any C/C++/FFI consumer — the Python bindings
 * (tpumon_torch/backends/agent.py) speak the same newline-delimited JSON
 * protocol (agent/protocol.md), so the two clients are
 * interchangeable against one daemon.
 *
 * Thread-safety: one in-flight request per client; calls on the same
 * client are serialized internally with a mutex (the dcgm api.go
 * mutex-guard convention).  Status codes reuse TPUMON_SHIM_*
 * (the port's include/tpumon_shim.h), with blanks reported out-of-band like the NVML
 * nil-on-NOT_SUPPORTED convention.
 */

#ifndef TPUMON_CLIENT_H
#define TPUMON_CLIENT_H

#include "tpumon_shim.h"

#ifdef __cplusplus
extern "C" {
#endif

typedef struct tpumon_client tpumon_client_t;

/* Connect to a running agent.  `address` is "unix:/path/to.sock" or
 * "host:port" (NULL = unix:/tmp/tpumon-hostengine.sock, the daemon's
 * default).  Returns NULL on failure and, if errbuf is non-NULL, writes a
 * human-readable reason (truncated to errlen). */
tpumon_client_t *tpumon_client_connect(const char *address, char *errbuf,
                                       int errlen);
void tpumon_client_close(tpumon_client_t *c);

/* Last error message for a failed call on this client ("" if none).
 * The returned pointer stays valid until the next tpumon_client_last_error
 * call on the same client; with multiple threads sharing a client,
 * retrieve the message from the thread whose call failed. */
const char *tpumon_client_last_error(tpumon_client_t *c);

/* ---- inventory --------------------------------------------------------- */

/* number of chips served by the agent; <0 on RPC failure */
int tpumon_client_chip_count(tpumon_client_t *c);

/* static info for one chip; TPUMON_SHIM_OK / ERR_NO_CHIP / ERR_INTERNAL */
int tpumon_client_chip_info(tpumon_client_t *c, int chip,
                            tpumon_chip_info_t *out);

/* ---- metrics -----------------------------------------------------------
 * Scalar field read for `n` field ids into values[n].  blanks[i] is set to
 * 1 when the field is unsupported/blank (value undefined) or is a vector
 * field (read those with tpumon_client_read_vector below), else 0.
 * Returns TPUMON_SHIM_OK, ERR_NO_CHIP, or ERR_INTERNAL. */
int tpumon_client_read_fields(tpumon_client_t *c, int chip,
                              const int *field_ids, int n, double *values,
                              unsigned char *blanks);

/* Vector (per-link) field read — the per-lane NVLink-counting analog
 * (nvml.go:539-568).  On entry *inout_len is the capacity of values[]; on
 * TPUMON_SHIM_OK it holds the element count.  ERR_UNSUPPORTED when the
 * agent does not serve the field as a vector. */
int tpumon_client_read_vector(tpumon_client_t *c, int chip, int field_id,
                              double *values, int *inout_len);

/* ---- agent-side watches (dcgmWatchFields analog) ------------------------ */

/* returns watch id >= 0, or <0 on failure */
long long tpumon_client_watch(tpumon_client_t *c, const int *field_ids,
                              int n, long long freq_us, double keep_age_s);
int tpumon_client_unwatch(tpumon_client_t *c, long long watch_id);

/* ---- daemon introspection (hostengine_status.go analog) ----------------- */

int tpumon_client_introspect(tpumon_client_t *c, double *cpu_percent,
                             double *memory_kb, long long *requests);

/* ---- async events (nvml event-set / XID analog, bindings.go:68-146) ------ */

typedef struct {
  int etype;          /* tpumon EventType numeric value */
  int chip_index;     /* -1 = not chip-scoped */
  double timestamp;   /* unix seconds */
  long long seq;      /* monotonic cursor; pass the max back as since_seq */
  char uuid[64];
  char message[160];
} tpumon_client_event_t;

/* Poll events with seq > since_seq into out[0..max_events); returns the
 * number filled (0 = none new), or a NEGATED tpumon_shim error code
 * (e.g. -TPUMON_SHIM_ERR_INTERNAL) on failure.  last_seq (optional)
 * receives the newest seq on the daemon, so a consumer can initialize
 * its cursor without draining history. */
int tpumon_client_poll_events(tpumon_client_t *c, long long since_seq,
                              tpumon_client_event_t *out, int max_events,
                              long long *last_seq);

#ifdef __cplusplus
}
#endif

#endif /* TPUMON_CLIENT_H */
