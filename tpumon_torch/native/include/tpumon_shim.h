/* tpumon_shim.h — the status codes and chip record shared by the port's
 * gpu-hostengine agent (tpumon_torch/native/agent/) and its C client
 * (tpumon_torch/native/client/).
 *
 * The part of the reference's shim header that the agent and the client
 * use, and nothing of its device ABI: the agent reads NVML itself
 * (agent/nvml_source.hpp, through tpumon_torch/testlib/nvml.h), so there
 * is no shim library to link.  The layouts are the reference's, so a
 * client built against either header reads the same record.
 */

#ifndef TPUMON_SHIM_H
#define TPUMON_SHIM_H

#ifdef __cplusplus
extern "C" {
#endif

/* ---- status codes (the Python clients' blank/missing conventions) ------ */

#define TPUMON_SHIM_OK 0
#define TPUMON_SHIM_ERR_LIB_NOT_FOUND 1   /* no device library on the host */
#define TPUMON_SHIM_ERR_UNSUPPORTED 2     /* metric not available here     */
#define TPUMON_SHIM_ERR_NO_CHIP 3         /* device index out of range     */
#define TPUMON_SHIM_ERR_INTERNAL 4

/* ---- one device's static record ---------------------------------------
 * dev_path is the device node its holders open (/dev/nvidia<minor>);
 * power_limit_mw is NVML's enforced limit. */

typedef struct tpumon_chip_info {
  int index;
  char uuid[64];
  char name[64];
  char serial[64];
  char dev_path[64];
  char firmware[64];
  long long hbm_total_mib;   /* <=0 means unknown */
  int tc_clock_mhz;          /* 0 means unknown   */
  int hbm_clock_mhz;
  long long power_limit_mw;  /* <=0 means unknown */
  int numa_node;             /* <0 means unknown  */
  char pci_bus_id[32];
  int coord_x, coord_y, coord_z;
} tpumon_chip_info_t;

#ifdef __cplusplus
}
#endif

#endif /* TPUMON_SHIM_H */
