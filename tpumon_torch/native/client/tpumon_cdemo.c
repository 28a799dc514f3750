/* tpumon_cdemo.c — pure-C consumer of libtpumon_client.
 *
 * Role analog of the reference's deviceInfo/dmon samples
 * (bindings/go/samples/dcgm/{deviceInfo,dmon}) for the C API: proves the
 * daemon is consumable without Python; it prints each card the agent
 * serves and a few dmon rows of it.  Usage:
 *
 *   tpumon-cdemo [unix:/path.sock | host:port] [sweeps]
 *
 * Prints static chip info once, then `sweeps` (default 3) 1 s dmon rows.
 */

#include <stdio.h>
#include <stdlib.h>
#include <unistd.h>

#include "tpumon_client.h"

/* field ids from tpumon_torch/fields.py (DCGM field-id analog) */
enum {
  F_CORE_TEMP = 150,
  F_POWER_USAGE = 155,
  F_TENSORCORE_UTIL = 203,
  F_HBM_TOTAL = 250,
  F_HBM_USED = 251,
};

int main(int argc, char **argv) {
  const char *addr = argc > 1 ? argv[1] : NULL;
  int sweeps = argc > 2 ? atoi(argv[2]) : 3;
  char err[256];
  tpumon_client_t *c = tpumon_client_connect(addr, err, sizeof(err));
  if (!c) {
    fprintf(stderr, "tpumon-cdemo: %s\n", err);
    return 1;
  }
  int n = tpumon_client_chip_count(c);
  if (n < 0) {
    fprintf(stderr, "tpumon-cdemo: %s\n", tpumon_client_last_error(c));
    tpumon_client_close(c);
    return 1;
  }
  printf("chips: %d\n", n);
  for (int i = 0; i < n; i++) {
    tpumon_chip_info_t info;
    if (tpumon_client_chip_info(c, i, &info) != TPUMON_SHIM_OK) continue;
    printf("chip %d: %s uuid=%s hbm=%lld MiB coords=(%d,%d,%d)\n", i,
           info.name, info.uuid, info.hbm_total_mib, info.coord_x,
           info.coord_y, info.coord_z);
  }

  const int fields[] = {F_POWER_USAGE, F_CORE_TEMP, F_TENSORCORE_UTIL,
                        F_HBM_USED};
  printf("# chip   pwr(W)  temp(C)  tcutil(%%)  hbm_used(MiB)\n");
  for (int s = 0; s < sweeps; s++) {
    for (int i = 0; i < n; i++) {
      double vals[4];
      unsigned char blanks[4];
      if (tpumon_client_read_fields(c, i, fields, 4, vals, blanks) !=
          TPUMON_SHIM_OK)
        continue;
      printf("%6d", i);
      for (int k = 0; k < 4; k++) {
        if (blanks[k])
          printf("  %8s", "-");
        else
          printf("  %8.1f", vals[k]);
      }
      printf("\n");
    }
    if (s + 1 < sweeps) sleep(1);
  }

  /* async events (XID analog): drain anything the daemon has seen —
   * chip resets, runtime restarts, kmsg-synthesized faults */
  tpumon_client_event_t evs[16];
  long long last_seq = 0;
  int got = tpumon_client_poll_events(c, 0, evs, 16, &last_seq);
  if (got > 0) {
    printf("events (%d, newest seq %lld):\n", got, last_seq);
    for (int k = 0; k < got; k++)
      printf("  seq=%lld chip=%d etype=%d %s\n", evs[k].seq,
             evs[k].chip_index, evs[k].etype, evs[k].message);
  } else if (got == 0) {
    printf("events: none\n");
  } else {
    fprintf(stderr, "tpumon-cdemo: events poll failed: %s\n",
            tpumon_client_last_error(c));
  }
  tpumon_client_close(c);
  return 0;
}
